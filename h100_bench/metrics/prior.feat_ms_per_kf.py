"""Device time per keyframe of the window of the DINO feature prior: the
program's device-marked span ``prior.feat`` (``models/priors.py``: the
whole predictor call, its resize, the DINOv2 network and the copy to the
host) between its CUDA event markers."""

SPAN = "prior.feat"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("keyframes")
    if not span or "device_s" not in span or not n:
        return None
    return span["device_s"] * 1e3 / n
