"""Host time of the mapping step's optim phase per iteration of the window:
the program's span ``map.step.optim`` inside ``map.step``
(``slam/mapper.py::Mapper._opt_step``), the densification statistics and the
three Adams; the step is launch-bound, so the host's time sets the pace."""

SPAN = "map.step.optim"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("iterations")
    if not span or not n:
        return None
    return span["total_s"] * 1e3 / n
