"""Host time per keyframe of the window that the priors spend outside their
networks' launches and the waits for the device (``models/priors.py``),
from the program's spans (``drivers/kf_intake.py::_prior_host_s``): the self
time of ``prior.depth`` and ``prior.feat``, the resizes, pads, crops and
copies of ``prior.depth.io`` and ``prior.feat.io`` from the moment the
device reaches each (a copy to or from the device waits for the work queued
ahead of it), and the caches' disk writes and reads, ``prior.cache``."""


def read(ctx):
    host, n = ctx.get("prior_host_s"), ctx.get("keyframes")
    if host is None or not n:
        return None
    return host * 1e3 / n
