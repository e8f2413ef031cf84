"""The BA's Schur term takes only the edges of the group table, in the
port as in the JAX package: ``make_edge_groups`` lists at most the first
16 edges of each source frame (``FactorGraph``'s ``group_degree``), and
the Schur products of the pose system take only those, while H, the
right-hand side, the depth diagonal and the depth back-substitution take
every edge.

The scene has frames that are the source of 17 and of 20 edges, at 12x16
pixels, its edges shuffled so that "the first 16" is the edge order and
not the frame order. Tolerances are test_ba's in
test_torch_tracking_ops.py: max-rel 1e-5 on poses and 1e-4 on
disparities (float32 sums in another order); the solve over the same
edges with every edge listed must differ by more than them, which shows
that the cap is reached. The graph case runs the oracle ``update_n`` of
both packages' ``FactorGraph`` through an ``rm_factors`` (its inactive
edges join the BA, after the active ones) on a window in which one frame
is the source of 19 edges: the edge order, and so the capped table,
must be the same in both. The mesh case holds the port's 2-shard BA
(``shard_edges_by_frame`` at the same degree) against the single-device
BA within test_multichip.py's 1e-5 abs + 1e-4 rel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.ops import dba as jdba
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.ops import projective as jproj
from wildgs_slam_tpu.slam import keyframe_store as jks
from wildgs_slam_tpu.slam.factor_graph import FactorGraph as JGraph
from wildgs_slam_tpu.slam.state import SlamState as JState
from wildgs_slam_tpu_torch.config import load_config
from wildgs_slam_tpu_torch.models import droid_net as tdn
from wildgs_slam_tpu_torch.ops import dba as tdba
from wildgs_slam_tpu_torch.parallel import collectives as col
from wildgs_slam_tpu_torch.parallel import mesh as tmesh
from wildgs_slam_tpu_torch.parallel import sharded_dba as tsdba
from wildgs_slam_tpu_torch.slam import factor_graph as tfg
from wildgs_slam_tpu_torch.slam import keyframe_store as tks
from wildgs_slam_tpu_torch.slam.state import SlamState as TState

torch.set_num_threads(1)
F, h, w = 22, 12, 16
DEGREE = 16
POSE_TOL, DISP_TOL = 1e-5, 1e-4


def J(a):
    return jnp.asarray(a)


def T(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def ba_scene(sensor):
    """22 frames; frame 0 the source of 17 edges, frame 2 of 20, a chain
    of neighbour edges, all shuffled; targets the true reprojection plus
    noise, random confidences, BA started from perturbed poses and
    disparities."""
    rng = np.random.RandomState(11)
    xi = np.concatenate([0.05 * rng.normal(size=(F, 3)),
                         0.03 * rng.normal(size=(F, 3))], -1)
    poses = np.array(jlie.se3_exp(J(xi.astype(np.float32))))
    poses[0] = [0, 0, 0, 0, 0, 0, 1]
    disps = (0.4 + 0.2 * rng.uniform(size=(F, h, w))).astype(np.float32)
    intr = np.array([12.0, 12.0, w / 2, h / 2], np.float32)
    edges = [(0, j) for j in range(1, 18)]
    edges += [(2, j) for j in range(F) if j != 2][:20]
    edges += [(i, i + 1) for i in range(3, F - 1)]
    edges += [(i + 1, i) for i in range(3, F - 1)]
    edges = [edges[k] for k in rng.permutation(len(edges))]
    ii = np.array([e[0] for e in edges])
    jj = np.array([e[1] for e in edges])
    tgt, _ = jproj.projective_transform(J(poses), J(disps), J(intr), J(ii),
                                        J(jj))
    tgt = (np.asarray(tgt) + 0.3 * rng.normal(size=tgt.shape)).astype(
        np.float32)
    wgt = rng.uniform(0.1, 1.0, size=tgt.shape).astype(np.float32)
    eta = rng.uniform(1e-3, 1e-2, size=(F, h, w)).astype(np.float32)
    poses0 = np.asarray(jlie.se3_retr(J(poses), J(
        0.01 * rng.normal(size=(F, 6)).astype(np.float32))))
    disps0 = (disps * (1 + 0.05 * rng.normal(size=disps.shape))).astype(
        np.float32)
    sens = None
    if sensor:
        sens = ((disps * (1 + 0.01 * rng.normal(size=disps.shape))).astype(
            np.float32), rng.uniform(size=disps.shape) > 0.2)
    return dict(poses=poses0, disps=disps0, intr=intr, tgt=tgt, wgt=wgt,
                eta=eta, ii=ii, jj=jj, sens=sens)


def port_ba(s, groups, iters=2):
    kw = {}
    if s["sens"] is not None:
        kw = dict(sensor_disps=T(s["sens"][0]), sensor_valid=T(s["sens"][1]))
    return tdba.ba(T(s["poses"]), T(s["disps"]), T(s["intr"]), T(s["tgt"]),
                   T(s["wgt"]), T(s["eta"]), T(s["ii"]), T(s["jj"]), groups,
                   1, F, iters=iters, **kw)


_jax_ba = jax.jit(jdba.ba, static_argnames=("iters", "cfg", "motion_only",
                                            "pmax"))


def test_make_edge_groups_matches_jax():
    s = ba_scene(False)
    for degree in (4, DEGREE, 32):
        np.testing.assert_array_equal(
            tdba.make_edge_groups(s["ii"], F, degree),
            jdba.make_edge_groups(s["ii"], F, degree))
    g = tdba.make_edge_groups(np.array([1, 5, 1, -1, 1, 2]), 4, 2)
    np.testing.assert_array_equal(
        g, [[-1, -1], [0, 2], [5, -1], [-1, -1]])
    assert g.dtype == np.int32
    listed = tdba.listed_edges(g, 6, "cpu")
    np.testing.assert_array_equal(listed, [1, 0, 1, 0, 0, 1])


@pytest.mark.parametrize("sensor", [False, True])
def test_ba_with_groups_matches_jax(sensor):
    s = ba_scene(sensor)
    deg = np.bincount(s["ii"])
    assert deg[0] == 17 and deg[2] == 20 and deg.max() == 20
    groups = tdba.make_edge_groups(s["ii"], F, DEGREE)
    jkw = {}
    if sensor:
        jkw = dict(sensor_disps=J(s["sens"][0]), sensor_valid=J(s["sens"][1]))
    rp, rd = _jax_ba(J(s["poses"]), J(s["disps"]), J(s["intr"]), J(s["tgt"]),
                     J(s["wgt"]), J(s["eta"]), J(s["ii"]), J(s["jj"]),
                     jnp.ones(len(s["ii"]), bool), J(groups), 1, F, iters=2,
                     pmax=F, **jkw)
    rp, rd = np.asarray(rp), np.asarray(rd)
    tp, td = port_ba(s, groups)
    assert np.abs(rp - s["poses"]).max() > 1e-3        # the solve moved
    assert max_rel(tp, rp) < POSE_TOL
    assert max_rel(td, rd) < DISP_TOL
    np.testing.assert_array_equal(tp[0].numpy(), s["poses"][0])
    # every edge listed: another solve, beyond the tolerances
    ap, ad = port_ba(s, tdba.make_edge_groups(s["ii"], F, 64))
    assert max_rel(ap, tp) > 10 * POSE_TOL
    assert max_rel(ad, td) > 10 * DISP_TOL


def test_sharded_ba_with_groups_matches_single_device():
    """A 2-shard mesh at the graph's degree against dba.ba with the same
    cap, with and without the sensor term."""
    for sensor in (False, True):
        s = ba_scene(sensor)
        E = len(s["ii"])
        ref = port_ba(s, tdba.make_edge_groups(s["ii"], F, DEGREE))
        mesh = tmesh.make_mesh(devices=["cpu"] * 2, axis="edge")
        meta = tsdba.shard_edges_by_frame(s["ii"], s["jj"], 2, F, DEGREE)
        e = tsdba.gather_edges([T(s["tgt"]), T(s["wgt"]), T(s["ii"]),
                                T(s["jj"])], meta["perm"])
        e.append(torch.as_tensor(meta["valid"].reshape(-1)))
        shards = [col.shard_rows(x, mesh.devices) for x in e]
        fn = tsdba.make_sharded_ba(mesh, F - 1, use_sensor=sensor, iters=2)
        sens = ((T(s["sens"][0]), T(s["sens"][1])) if sensor
                else (None, None))
        p, d = fn(T(s["poses"]), T(s["disps"]), T(s["intr"]), shards[0],
                  shards[1], T(s["eta"]), *shards[2:], meta["groups"],
                  meta["owner"], 1, F, *sens)
        assert int(meta["valid"].sum()) == E
        np.testing.assert_allclose(p, ref[0], atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(d, ref[1], atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the factor graph: edge order through add_factors, rm_factors, update_n
# ---------------------------------------------------------------------------

GH, GW = 96, 128         # the store's images; its disparities are 12x16
GF = 24                  # store slots


def graph_scene():
    """Ground-truth poses and a seeded store's contents: perturbed poses,
    disparities near 0.5, random feature maps."""
    rng = np.random.RandomState(3)
    xi = np.zeros((GF, 6), np.float32)
    xi[:, 0] = 0.03 * np.arange(GF)
    xi[:, 1] = 0.01 * np.sin(np.arange(GF))
    gt = np.asarray(jlie.se3_exp(J(xi)))
    pert = np.array(jlie.se3_retr(J(gt), J(
        0.005 * rng.normal(size=(GF, 6)).astype(np.float32))))
    pert[0] = gt[0]
    disps = (0.5 + 0.02 * rng.randn(GF, GH // 8, GW // 8)).astype(np.float32)
    fmaps = (0.5 * rng.randn(GF, GH // 8, GW // 8, 128)).astype(np.float32)
    return gt, pert, disps, fmaps


def graph_edges(g):
    """Frame 3 the source of 12, then 8 more edges around a neighbourhood
    block; 5 edges moved to the inactive list (3 of frame 3's among them);
    3 more edges after the compaction."""
    g.add_factors([3] * 12, list(range(4, 16)))
    g.add_neighborhood_factors(8, 20, r=2)
    g.add_factors([3] * 8, [0, 1, 2] + list(range(16, 21)))
    g.rm_factors(np.isin(np.arange(g.E), [1, 5, 13, 30, 31]), store=True)
    g.add_factors([3, 3, 10], [21, 22, 3])


def cfg_intr():
    return (load_config("configs/wildgs_slam.yaml"),
            np.array([60.0, 60.0, GW / 2, GH / 2]))


def port_graph(scene):
    gt, pert, disps, fmaps = scene
    cfg, intr = cfg_intr()
    ts = TState.create(cfg, GH, GW, intr, buffer=GF, device="cpu")
    for i in range(GF):
        tks.append(ts.store, i, float(i), pose=pert[i], disp=disps[i],
                   fmap=fmaps[i])
    ts.counter = GF
    ts.metric_depth_reg = ts.uncertainty_aware = False
    tg = tfg.FactorGraph(ts, tdn.DroidNet().eval(), max_factors=-1)
    tg.gt_injection = lambda store, counter: (
        torch.from_numpy(gt), torch.full(store.disps.shape, 0.5))
    graph_edges(tg)
    return ts, tg


def jax_graph(scene):
    gt, pert, disps, fmaps = scene
    cfg, intr = cfg_intr()
    js = JState.create(cfg, GH, GW, intr, buffer=GF)
    store = js.store
    for i in range(GF):
        store = jks.append(store, i, float(i), pose=J(pert[i]),
                           disp=J(disps[i]), fmap=J(fmaps[i]))
    js.store = store
    js.counter = GF
    js.metric_depth_reg = js.uncertainty_aware = False
    jg = JGraph(js, None, max_factors=-1, pmax=GF)
    jg.gt_injection = lambda store, counter: (
        J(gt), jnp.full(store.disps.shape, 0.5))
    graph_edges(jg)
    return js, jg


def test_graph_oracle_update_n_caps_like_jax(monkeypatch):
    monkeypatch.setattr(jdba, "ba_iteration", jax.jit(
        jdba.ba_iteration, static_argnames=("cfg", "motion_only", "pmax")))
    scene = graph_scene()
    js, jg = jax_graph(scene)
    ts, tg = port_graph(scene)
    for name in ("ii", "jj", "ii_inac", "jj_inac"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    deg = np.bincount(np.concatenate([tg.ii, tg.ii_inac]))
    assert deg[3] > DEGREE and 3 in tg.ii_inac
    for g in (jg, tg):
        g.update_n(2, 1, GF, use_inactive=True)
    tp, td = ts.store.poses.numpy(), ts.store.disps.numpy()
    assert np.abs(tp - scene[1]).max() > 1e-3        # the solve moved
    assert max_rel(tp, js.store.poses) < POSE_TOL
    assert max_rel(td, js.store.disps) < DISP_TOL
    np.testing.assert_array_equal(tg.age, jg.age)

    # every edge of frame 3 listed: another solve, beyond the tolerances
    monkeypatch.setattr(tfg, "GROUP_DEGREE", 64)
    ts2, tg2 = port_graph(scene)
    tg2.update_n(2, 1, GF, use_inactive=True)
    assert max_rel(ts2.store.poses, tp) > 10 * POSE_TOL
