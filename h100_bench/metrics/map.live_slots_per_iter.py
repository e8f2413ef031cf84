"""Live tile-list entries per iteration of the window: the program's
device counter ``map.live_slots``, the sum of the binning's per-tile counts
in each optimising render (``slam/mapper.py::Mapper._opt_step``), the work
K1 and K2 walk through.

An explanatory count, not a speed: read it beside the render's and the
backward's times. It falls soundly only where binning drops tile entries
that add nothing to the image (a tighter footprint test); a change that
drops entries that do add to it renders another image, which the
benchmark's comparison has to catch."""

COUNTER = "map.live_slots"


def read(ctx):
    c, n = (ctx.get("timer") or {}).get(COUNTER), ctx.get("iterations")
    if not c or not n:
        return None
    return c["total"] / n
