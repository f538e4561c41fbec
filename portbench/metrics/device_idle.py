"""The card's idle share of the traced window, in %: 1 - the union of
its device operations' intervals over the window's length."""


def read(ctx):
    if ctx.events is None:
        return None
    lo, hi = ctx.trace
    return 100.0 * (1.0 - ctx.busy_s() / (hi - lo))
