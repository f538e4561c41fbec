"""Device operations of a decode step: the trace's operations (kernels
and copies) that start inside one of the program's ``exec.decode`` spans
of the traced part, over the number of those spans."""
from portbench.harness import wall


def read(ctx):
    steps = wall.traced(ctx, "exec.decode")
    if not steps or ctx.events is None:
        return None
    return float(wall.starts_in(steps, ctx.events).sum()) / len(steps)
