"""The frontend (``slam/frontend.py``: graph update, ``factor_graph.py::
update_n``, ``ops/dba.py``) per kept keyframe of a traced window: the
harness's synced spans around the frontend calls of the frames that left a
new keyframe."""


def read(ctx):
    sp, n = ctx.get("spans"), ctx.get("keyframes")
    if not sp or not n:
        return None
    return sp["fe_kf_s"] * 1e3 / n
