"""Device time per keyframe of the window of the metric depth prior: the
program's device-marked span ``prior.depth`` (``models/priors.py``: the
whole predictor call, its resizes, pad and crop, the DepthAnythingV2
network and the copy to the host) between its CUDA event markers."""

SPAN = "prior.depth"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("keyframes")
    if not span or "device_s" not in span or not n:
        return None
    return span["device_s"] * 1e3 / n
