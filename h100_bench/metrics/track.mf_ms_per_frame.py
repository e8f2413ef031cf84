"""The motion filter (``slam/motion_filter.py::MotionFilter.track``) per
frame of a traced window: the harness's span around each call, ended by a
device synchronisation."""


def read(ctx):
    sp, n = ctx.get("spans"), ctx.get("frames")
    if not sp or not n:
        return None
    return sp["mf_s"] * 1e3 / n
