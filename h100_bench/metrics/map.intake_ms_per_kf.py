"""Keyframe intake before the optimisation, per keyframe of the window: the
mapper's synced phases ``map.kf_resync_deform`` (re-sync of moved
keyframes), ``map.window_update`` (covisibility render and window) and
``map.seed_gaussians`` (seeding), from the program's ``TIMER``."""

PHASES = ("map.kf_resync_deform", "map.window_update", "map.seed_gaussians")


def read(ctx):
    timer, n = ctx.get("timer") or {}, ctx.get("keyframes") or 0
    if not n or not any(p in timer for p in PHASES):
        return None
    return sum(timer[p]["total_s"] for p in PHASES if p in timer) * 1e3 / n
