"""The depth prior's head's share of the card's fp32 peak: the operations
of the DPT head (``models/dpt.py::DPTHead``: every convolution in its direct
form; ``counts/priors.py``, per call at the network's input grid), times its
calls in the window, over the device time of the program's device-marked
span ``prior.depth.head`` at 67 TFLOP/s (the configuration computes in
float32)."""

SPAN = "prior.depth.head"


def read(ctx):
    span, ops = (ctx.get("timer") or {}).get(SPAN), ctx.get("prior_ops")
    if not span or not span.get("device_s") or not ops:
        return None
    return (ops["head"] * span["count"]
            / (span["device_s"] * ctx["peaks"]["fp32_flops"]) * 100.0)
