"""The decode steps' share of the card's peak, in %: the least time for
every decode step of the window's untraced part (weights and live KV or state read,
FLOPs of each row, counted by the family's reference module) over their
summed host-clock wall."""
from portbench.harness.roofline import least_s


def read(ctx):
    calls = ctx.of("decode_batch")
    if not calls:
        return None
    need = sum(least_s(*ctx.ref.decode_work(ctx.cfg, s.ctxs)) for s in calls)
    return 100.0 * need / ctx.wall("decode_batch")
