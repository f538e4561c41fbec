"""Host-clock milliseconds of the program's ``decode.prepare`` span, the
mean over every decode step of the window's untraced part:
``RealExecutor.decode_batch`` building the step's inputs (tokens,
positions, each row's new page and the block table, copied to the
card)."""
from portbench.harness import wall


def read(ctx):
    return wall.mean_ms(ctx, "decode.prepare")
