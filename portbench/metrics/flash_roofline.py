"""``kernels/flash_prefill.py``'s share of its roofline, in %: the least
time of every flash call of the traced window (one a layer a prefill,
causal, B = 1, at the prompt's length) over the device time of the
``flash_fwd_hopper`` kernels in the trace."""
from portbench.harness.roofline import flash_work, least_s

KERNEL = "flash_fwd_hopper"


def read(ctx):
    dev = ctx.kernel_s(KERNEL)
    if not dev:
        return None
    c = ctx.cfg
    need = sum(c["num_layers"] * least_s(*flash_work(
        s.tokens, c["num_heads"], c["num_kv_heads"], c["head_dim"]))
        for s in ctx.traced_of("prefill"))
    return 100.0 * need / dev
