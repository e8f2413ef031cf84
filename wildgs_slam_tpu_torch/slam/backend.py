"""Backend: global dense BA and loop closure; torch port of
``wildgs_slam_tpu/slam/backend.py``.

``dense_ba`` builds a fresh full-window factor graph with on-the-fly
correlation and runs ``update_lowmem`` on it, then refreshes every live
frame's depth mask; ``loop_ba`` runs the windowed loop-closure BA on a
graph seeded with the frontend's live edges. ``gt_injection`` is handed
to every graph the backend builds.
"""

from __future__ import annotations

from ..utils.profiling import TIMER
from . import keyframe_store as kstore
from .factor_graph import FactorGraph


class Backend:
    def __init__(self, state, model, cfg, uncertainty_update_fn=None):
        self.state = state
        self.model = model
        self.cfg = cfg
        t = cfg["tracking"]
        b = t["backend"]
        self.beta = t["beta"]
        self.backend_thresh = b["thresh"]
        self.backend_radius = b["radius"]
        self.backend_nms = b["nms"]
        self.backend_normalize = b["normalize"]
        self.loop_window = b["loop_window"]
        self.loop_thresh = b["loop_thresh"]
        self.loop_radius = b["loop_radius"]
        self.loop_nms = b["loop_nms"]
        self.multiview_thresh = t["multiview_filter"]["thresh"]
        self.multiview_visible_num = t["multiview_filter"]["visible_num"]
        self.uncertainty_update_fn = uncertainty_update_fn  # () -> None
        # oracle hook (see FactorGraph.gt_injection), given to every graph
        self.gt_injection = None

    def _graph(self, max_factors):
        g = FactorGraph(self.state, self.model, max_factors=max_factors,
                        corr_impl="alt")
        g.gt_injection = self.gt_injection
        return g

    def backend_ba(self, t_start, t_end, steps, graph, nms, radius, thresh,
                   max_factors, t_start_loop=None, loop=False):
        """Propose the edges, run update_lowmem over [t_start_loop + 1,
        t_end), clear the graph. Returns the edge count (0: no BA ran)."""
        if self.uncertainty_update_fn is not None:
            self.uncertainty_update_fn()
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        with TIMER.phase("track.lowmem.proposal"):
            edge_num = graph.add_backend_proximity_factors(
                t_start, t_end, nms, radius, thresh, max_factors, self.beta,
                t_start_loop, loop)
        if edge_num == 0:
            graph.clear_edges()
            return 0
        graph.update_lowmem(t0=t_start_loop + 1, t1=t_end, itrs=2,
                            steps=steps)
        graph.clear_edges()
        return edge_num

    def dense_ba(self, steps=6):
        """Global BA over every live keyframe. Returns (frames, edges)."""
        t_start, t_end = 0, self.state.counter
        n = t_end - t_start
        max_factors = (self.backend_radius + 2) * 2 * n
        if self.backend_normalize:
            kstore.normalize(self.state.store, t_end)
        graph = self._graph(max_factors)
        n_edges = self.backend_ba(t_start, t_end, steps, graph,
                                  self.backend_nms, self.backend_radius,
                                  self.backend_thresh, max_factors)
        with TIMER.phase("track.lowmem.depth_mask"):
            kstore.update_valid_depth_mask(
                self.state.store, self.state.counter, self.multiview_thresh,
                self.multiview_visible_num)
        return n, n_edges

    def loop_ba(self, t_start, t_end, steps=6, motion_only=False,
                local_graph=None):
        """Loop-closure BA over the last loop_window keyframes against every
        frame from t_start. Returns (window frames, edges)."""
        max_factors = 8 * self.loop_window
        t_start_loop = max(0, t_end - self.loop_window)
        graph = self._graph(max_factors)
        if local_graph is not None:
            graph.adopt_edges(local_graph)
        left = max_factors - graph.E
        n_edges = self.backend_ba(t_start, t_end, steps, graph,
                                  self.loop_nms, self.loop_radius,
                                  self.loop_thresh, left,
                                  t_start_loop=t_start_loop, loop=True)
        return t_end - t_start_loop, n_edges
