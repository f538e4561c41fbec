"""``kernels/rwkv6_scan.py``'s share of its roofline, in %: the least
time of every scan call of the traced window (one a layer a prefill, the
prompt padded to the port's chunk of 64) over the device time of the
``rwkv6_chunked`` kernels in the trace."""
from portbench.harness.roofline import least_s, rwkv6_scan_work

KERNEL = "rwkv6_chunked"
CHUNK = 64


def read(ctx):
    dev = ctx.kernel_s(KERNEL)
    if not dev:
        return None
    c = ctx.cfg
    hd = c["rwkv"]["head_dim"]
    need = sum(c["num_layers"] * least_s(*rwkv6_scan_work(
        -(-s.tokens // CHUNK) * CHUNK, c["d_model"] // hd, hd))
        for s in ctx.traced_of("prefill"))
    return 100.0 * need / dev
