"""The prefill calls' share of the card's peak, in %: the least time the
card could take for every prefill call of the window's untraced part
(the larger of its
FLOPs at the bf16 peak and its bytes at the HBM rate, counted from the
prompt lengths by the family's reference module) over their summed
host-clock wall."""
from portbench.harness.roofline import least_s


def read(ctx):
    calls = ctx.of("prefill")
    if not calls:
        return None
    need = sum(least_s(*ctx.ref.prefill_work(ctx.cfg, s.tokens))
               for s in calls)
    return 100.0 * need / ctx.wall("prefill")
