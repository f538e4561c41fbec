"""The serving loop's share of the window's untraced part: the time no
call of the
port's executor or transfer path was running (the cluster's
simulated clock, its routing and bookkeeping, building each wave), in
%."""


def read(ctx):
    window = ctx.t1 - ctx.t0
    calls = sum(s.t1 - s.t0 for s in ctx.spans)
    return 100.0 * (window - calls) / window
