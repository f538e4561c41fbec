"""Host-clock milliseconds of the program's ``decode.forward`` span, the
mean over every decode step of the window's untraced part: the host's
time to enqueue one step of the model (the call returns once its work
is launched; the wait for the card comes after, in ``decode.sync``)."""
from portbench.harness import wall


def read(ctx):
    return wall.mean_ms(ctx, "decode.forward")
