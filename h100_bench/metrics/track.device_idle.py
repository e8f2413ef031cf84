"""Share of the tracker's profiled stretch in which no operation ran on
the device."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st["n_ops"] or not st["wall_s"]:
        return None
    return (1.0 - st["busy_s"] / st["wall_s"]) * 100.0
