"""Host time of the mapping step's render phase per iteration of the window:
the program's span ``map.step.render`` inside ``map.step``
(``slam/mapper.py::Mapper._opt_step``), the render (leaf detach, projection,
binning's sorts, K3, K1); the step is launch-bound, so the host's time sets
the pace."""

SPAN = "map.step.render"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("iterations")
    if not span or not n:
        return None
    return span["total_s"] * 1e3 / n
