"""Active edges per graph update iteration of the window
(``slam/factor_graph.py::FactorGraph.update_n``): the program's counters
``track.edges`` over ``track.update_iters``. An iteration's update operator
and BA work grow with its edges.

An explanatory count, not a speed: the factor graph's rules
(``max_factors``, the proximity and age thresholds) set it, and a change
that only makes tracking faster leaves it where it is. It is declared
``higher`` so that a change dropping edges, which is less of the
mathematics, does not read as a gain."""


def read(ctx):
    timer = ctx.get("timer") or {}
    edges, iters = timer.get("track.edges"), timer.get("track.update_iters")
    if not edges or not iters or not iters["total"]:
        return None
    return edges["total"] / iters["total"]
