"""The tracker's share of the card's fp32 peak over the profiled stretch:
the operations of ``counts/tracker.py`` for its frames, keyframes, graph
iterations and new edges, over the stretch's wall time at 67 TFLOP/s (the
configuration computes in float32)."""


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st.get("ops") or not st["wall_s"]:
        return None
    return st["ops"] / (st["wall_s"] * ctx["peaks"]["fp32_flops"]) * 100.0
