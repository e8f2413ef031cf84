"""Host time of the mapping step's backward phase per iteration of the
window: the program's span ``map.step.backward`` inside ``map.step``
(``slam/mapper.py::Mapper._opt_step``), autograd's backward (K2, K4, the
losses' backward) and the zero fill; the step is launch-bound, so the host's
time sets the pace."""

SPAN = "map.step.backward"


def read(ctx):
    span, n = (ctx.get("timer") or {}).get(SPAN), ctx.get("iterations")
    if not span or not n:
        return None
    return span["total_s"] * 1e3 / n
