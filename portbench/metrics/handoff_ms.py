"""Host-clock milliseconds of one request's handoff: its store (the
executor's gather and the path's copy to pinned host memory) and its
fetch (the copy back and the executor's write into the pool), the mean
over the requests stored in the window's untraced part."""


def read(ctx):
    stored = ctx.of("store")
    if not stored:
        return None
    return 1e3 * (ctx.wall("store") + ctx.wall("fetch")) / len(stored)
