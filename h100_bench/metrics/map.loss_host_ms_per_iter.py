"""Host time of the mapping step's loss phase per iteration of the window:
the program's span ``map.step.loss`` inside ``map.step``
(``slam/mapper.py::Mapper._opt_step``), the losses (the uncertainty MLP,
SSIM, the DINO regularizer, the isotropic term); the step is launch-bound,
so the host's time sets the pace."""

SPAN = "map.step.loss"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("iterations")
    if not span or not n:
        return None
    return span["total_s"] * 1e3 / n
