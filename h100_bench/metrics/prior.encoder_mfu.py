"""The depth prior's encoder's share of the card's fp32 peak: the
operations of the ViT-L encoder (``models/dinov2.py`` inside
``models/dpt.py::DepthAnythingV2``: the patch embedding, the blocks' GEMMs
and the attention's two products; ``counts/priors.py``, per call at the
network's input grid), times its calls in the window, over the device time
of the program's device-marked span ``prior.depth.encoder`` at 67 TFLOP/s
(the configuration computes in float32)."""

SPAN = "prior.depth.encoder"


def read(ctx):
    span, ops = (ctx.get("timer") or {}).get(SPAN), ctx.get("prior_ops")
    if not span or not span.get("device_s") or not ops:
        return None
    return (ops["encoder"] * span["count"]
            / (span["device_s"] * ctx["peaks"]["fp32_flops"]) * 100.0)
