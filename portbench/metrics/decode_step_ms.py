"""Host-clock milliseconds of one ``RealExecutor.decode_batch`` call, the
mean over every decode step of the window's untraced part."""


def read(ctx):
    calls = ctx.of("decode_batch")
    if not calls:
        return None
    return 1e3 * ctx.wall("decode_batch") / len(calls)
