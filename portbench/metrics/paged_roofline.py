"""``kernels/paged_decode.py``'s share of its roofline, in %: the least
time of every paged call of the traced window (one a layer a decode step,
the step's rows at their context + 1) over the device time of the
``paged_split`` kernels in the trace."""
from portbench.harness.layers import PAGE
from portbench.harness.roofline import least_s, paged_work

KERNEL = "paged_split"


def read(ctx):
    dev = ctx.kernel_s(KERNEL)
    if not dev:
        return None
    c = ctx.cfg
    need = sum(c["num_layers"] * least_s(*paged_work(
        [n + 1 for n in s.ctxs], c["num_heads"], c["num_kv_heads"],
        c["head_dim"], PAGE)) for s in ctx.traced_of("decode_batch"))
    return 100.0 * need / dev
