"""Host-clock milliseconds of ``RealExecutor.prefill`` per thousand
prompt tokens, over every prefill call of the window's untraced part."""


def read(ctx):
    calls = ctx.of("prefill")
    tokens = sum(s.tokens for s in calls)
    if not tokens:
        return None
    return 1e3 * ctx.wall("prefill") / tokens * 1e3
