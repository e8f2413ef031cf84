"""Keyframes kept over frames taken in the window: the traffic's own mix,
which sets how many frames pay a graph update."""


def read(ctx):
    n = ctx.get("frames")
    if not n or ctx.get("keyframes") is None:
        return None
    return ctx["keyframes"] / n * 100.0
