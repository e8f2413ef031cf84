"""Share of the keyframe intake's profiled stretch in which no operation
ran on the device: 1 - busy / wall, the busy time the union of the device's
operation intervals (torch.profiler, CUDA activity)."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st["n_ops"] or not st["wall_s"]:
        return None
    return (1.0 - st["busy_s"] / st["wall_s"]) * 100.0
