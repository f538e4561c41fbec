"""The card waiting on launches, in %: the share of the traced window in
which no device operation runs while the host is inside the program's
``decode.forward`` or ``prefill.forward`` span, by exact intersection of
the spans with the device's idle intervals."""
import numpy as np

from portbench.harness import wall


def read(ctx):
    spans = wall.every(ctx)
    if spans is None or ctx.events is None:
        return None
    spans = [s for s in spans if s.name in wall.ENQUEUE]
    if not spans:
        return None
    lo, hi = ctx.trace
    idle = wall.idle_measure(ctx.events, lo, hi)(
        np.asarray([s.t0 for s in spans]), np.asarray([s.t1 for s in spans]))
    return 100.0 * float(idle.sum()) / (hi - lo)
