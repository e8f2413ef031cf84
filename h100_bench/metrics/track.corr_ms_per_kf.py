"""Device time per kept keyframe of the window of one phase of the graph
update iterations (``slam/factor_graph.py::FactorGraph.update_n``): the
program's device-marked span ``track.upd.corr``, the reprojection, the
motion features and the correlation lookup, between its CUDA event markers."""

SPAN = "track.upd.corr"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("keyframes")
    if not span or "device_s" not in span or not n:
        return None
    return span["device_s"] * 1e3 / n
