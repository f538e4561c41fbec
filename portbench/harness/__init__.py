"""The harness of the port's benchmark: data, window, checks."""
