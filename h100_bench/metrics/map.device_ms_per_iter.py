"""Device time per mapping iteration over the profiled stretch: the union
of the device's operation intervals (overlaps counted once), per step."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st["n_ops"] or not st["steps"]:
        return None
    return st["busy_s"] * 1e3 / st["steps"]
