"""Device time per frame over the tracker's profiled stretch: the union of
the device's operation intervals, over the stretch's frames."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st["n_ops"] or not st.get("frames"):
        return None
    return st["busy_s"] * 1e3 / st["frames"]
