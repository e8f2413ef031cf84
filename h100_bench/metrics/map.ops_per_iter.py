"""Device operations (kernels, copies, fills) per mapping iteration over
the profiled stretch: the launches the host issues for one step."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st["n_ops"] or not st["steps"]:
        return None
    return st["n_ops"] / st["steps"]
