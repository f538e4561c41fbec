"""Rows of a decode step: the mean ``rows`` of the program's
``exec.decode`` spans over the window's untraced part (the batch the
serving loop hands the executor)."""
from portbench.harness import wall


def read(ctx):
    steps = wall.untraced(ctx, "exec.decode")
    if not steps:
        return None
    return sum(s.args["rows"] for s in steps) / len(steps)
