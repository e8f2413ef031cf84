"""The port's multi-device mode (``wildgs_slam_tpu_torch/parallel/``) on
an 8-shard CPU mesh, ``make_mesh(devices=["cpu"] * 8)``: each case of
``tests/test_multichip.py`` at its sizes, the port's sharded function held
against the JAX sharded function on conftest's 8-device virtual CPU mesh
and against the port's single-device function, on the same seeded numpy
inputs.

Tolerances are test_multichip.py's (the sharded paths sum in another
order): DBA poses and disparities 1e-5 abs + 1e-4 rel; the track step's
poses, disparities, upsampled disparities and per-edge states 1e-5 + 1e-4,
damping 1e-6 + 1e-4; the render 2e-5 + 1e-4 (depth 2e-4 in the padded
case), its gradients 5e-4 + 1e-3; the sharded ``_opt_segment`` losses
2e-4 rel, the map 2e-3, exposure and the uncertainty MLP 1e-5. Against the
port's own single-device function the render is equal to the bit on these
scenes (the merge reorders nothing the single sort does not), and the
rest agrees within the same tolerances. The mapping cases (the padded
render, the sharded ``_opt_segment``, the train step) are in
test_torch_parallel_mapping.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.models import droid_net as jdn
from wildgs_slam_tpu.ops import correlation as jcorr
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.ops import projective as jproj
from wildgs_slam_tpu.parallel import mesh as jmesh
from wildgs_slam_tpu.parallel import sharded_dba as jsdba
from wildgs_slam_tpu.parallel import sharded_raster as jsr
from wildgs_slam_tpu.parallel import sharded_track as jst
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.models import droid_net as tdn
from wildgs_slam_tpu_torch.ops import correlation as tcorr
from wildgs_slam_tpu_torch.ops import dba as tdba
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.parallel import collectives as col
from wildgs_slam_tpu_torch.parallel import mesh as tmesh
from wildgs_slam_tpu_torch.parallel import sharded_dba as tsdba
from wildgs_slam_tpu_torch.parallel import sharded_raster as tsr
from wildgs_slam_tpu_torch.parallel import sharded_track as tst
from wildgs_slam_tpu_torch.slam.state import SlamState as TState

torch.set_num_threads(1)
ND = 8


def need_devices():
    if jax.device_count() < ND:
        pytest.skip(f"needs {ND} JAX devices")


def cpu_mesh(n=ND, axis="g"):
    return tmesh.make_mesh(devices=["cpu"] * n, axis=axis)


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(port, ref, atol, rtol, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# the mesh and the collectives
# ---------------------------------------------------------------------------

def test_make_mesh_and_collectives():
    m = cpu_mesh(4, axis="view")
    assert m.size == 4 and m.axis_names == ("view",)
    assert all(d == torch.device("cpu") for d in m.devices)
    with pytest.raises(ValueError, match="parallel.n_devices=2 but only 0 "
                                         "devices visible"):
        tmesh.make_mesh(2)          # no card here: never the CPU on its own
    xs = [torch.full((2, 3), float(d), requires_grad=True) for d in range(4)]
    s = col.psum(xs, m.devices)
    assert all(t is s[0] for t in s)          # formed once per device
    assert torch.equal(s[0], torch.full((2, 3), 6.0))
    g = col.all_gather(xs, m.devices)[0]
    assert torch.equal(g, torch.cat(xs))
    a2a = col.all_to_all([x.reshape(2, 3).repeat(2, 1)[:4] for x in xs],
                         m.devices)
    assert a2a[1].shape == (4, 3)
    assert torch.equal(a2a[2][3], xs[3][0])
    # transposes: all_gather -> the sum of the slices, psum -> psum
    (g * torch.arange(24.0).reshape(8, 3)).sum().backward(retain_graph=True)
    assert torch.equal(xs[1].grad, torch.arange(6.0, 12.0).reshape(2, 3))
    for x in xs:
        x.grad = None
    s[0].sum().backward()
    assert all(torch.equal(x.grad, torch.ones(2, 3)) for x in xs)
    for size, n in (((40, 48), 8), ((384, 512), 5), ((33, 17), 3)):
        assert (tmesh.pad_image_size_for_mesh(size, n)
                == jmesh.pad_image_size_for_mesh(size, n))
    assert tmesh.pad_gaussian_capacity(4097, 8) == 4104


# ---------------------------------------------------------------------------
# sharded DBA
# ---------------------------------------------------------------------------

F, H, W = 8, 6, 8
INTR = np.array([8.0, 8.0, W / 2 - 0.5, H / 2 - 0.5], np.float32)


def se3_exp(xi):
    return np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))


def dba_problem(seed=0, perturb=0.03):
    rng = np.random.RandomState(seed)
    poses_gt = se3_exp(0.04 * rng.randn(F, 6))
    disps_gt = (0.5 + 0.2 * rng.rand(F, H, W)).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(F), np.arange(F), indexing="ij")
    keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= 2)
    ii, jj = ii[keep], jj[keep]
    target, _ = jproj.projective_transform(
        jnp.asarray(poses_gt), jnp.asarray(disps_gt), jnp.asarray(INTR),
        jnp.asarray(ii), jnp.asarray(jj))
    target = np.asarray(target)
    weight = (0.5 + 0.5 * rng.rand(*target.shape)).astype(np.float32)
    poses0 = np.asarray(jlie.se3_mul(
        jnp.asarray(se3_exp(perturb * rng.randn(F, 6))),
        jnp.asarray(poses_gt)))
    disps0 = (disps_gt + perturb * rng.randn(F, H, W)).astype(np.float32)
    return dict(poses0=poses0, disps0=disps0, target=target, weight=weight,
                eta=np.full((F, H, W), 0.05, np.float32), ii=ii, jj=jj,
                sensor=(disps_gt * 1.1).astype(np.float32),
                sensor_valid=np.ones((F, H, W), bool))


@pytest.mark.parametrize("use_sensor", [False, True])
def test_sharded_dba_matches_jax_and_single_device(use_sensor):
    need_devices()
    p = dba_problem()
    t0, t1, pmax = 1, F, F - 1
    E = p["ii"].shape[0]
    meta = tsdba.shard_edges_by_frame(p["ii"], p["jj"], ND, F, degree=16)
    jmeta = jsdba.shard_edges_by_frame(p["ii"], p["jj"], ND, F, degree=16)
    for k in ("perm", "valid", "groups", "owner", "e_cap"):
        np.testing.assert_array_equal(meta[k], jmeta[k])
    vmask = meta["valid"].reshape(-1)

    # JAX sharded
    jm = jmesh.make_mesh(ND, axis="edge")
    tgt, wgt, iiv, jjv, vv = jsdba.gather_edges(
        [p["target"], p["weight"], p["ii"], p["jj"], np.ones(E, bool)],
        meta["perm"])
    fn = jsdba.make_sharded_ba(jm, F, (H, W), meta["e_cap"], pmax, degree=16,
                               use_sensor=use_sensor, iters=2)
    jp, jd = fn(jnp.asarray(p["poses0"]), jnp.asarray(p["disps0"]),
                jnp.asarray(INTR), tgt, wgt, jnp.asarray(p["eta"]), iiv, jjv,
                vv & jnp.asarray(vmask), jnp.asarray(meta["groups"]),
                jnp.asarray(meta["owner"]), jnp.int32(t0), jnp.int32(t1),
                jnp.asarray(p["sensor"]), jnp.asarray(p["sensor_valid"]))

    # the port, sharded and single-device
    tm = cpu_mesh(axis="edge")
    tg = tsdba.gather_edges(
        [T(p["target"]), T(p["weight"]), T(p["ii"], torch.int64),
         T(p["jj"], torch.int64), torch.ones(E, dtype=torch.bool)],
        meta["perm"])
    tg[4] = tg[4] & torch.as_tensor(vmask)
    sh = [col.shard_rows(x, tm.devices) for x in tg]
    tfn = tsdba.make_sharded_ba(tm, pmax, use_sensor=use_sensor, iters=2)
    sens = (T(p["sensor"]), T(p["sensor_valid"], torch.bool))
    tp, td = tfn(T(p["poses0"]), T(p["disps0"]), T(INTR), *sh[:2],
                 T(p["eta"]), *sh[2:], meta["groups"], meta["owner"], t0,
                 t1, *sens)
    rp, rd = tdba.ba(T(p["poses0"]), T(p["disps0"]), T(INTR), T(p["target"]),
                     T(p["weight"]), T(p["eta"]), T(p["ii"], torch.int64),
                     T(p["jj"], torch.int64),
                     tdba.make_edge_groups(p["ii"], F, 16), t0, t1, iters=2,
                     sensor_disps=sens[0] if use_sensor else None,
                     sensor_valid=sens[1] if use_sensor else None)
    assert float((tp - T(p["poses0"])).abs().max()) > 1e-3   # it moved
    for port, ref in ((tp, jp), (td, jd), (tp, rp), (td, rd)):
        close(port, ref, 1e-5, 1e-4)


# ---------------------------------------------------------------------------
# sharded track step (lookup + update operator + BA + upsample)
# ---------------------------------------------------------------------------

def track_problem(FB=16, n=8):
    h, w = H, W
    rng = np.random.RandomState(0)
    poses = se3_exp(0.03 * rng.randn(FB, 6))
    disps = (0.4 + 0.3 * rng.rand(FB, h, w)).astype(np.float32)
    uncert = rng.rand(FB, h, w).astype(np.float32)
    mono = (0.5 + 0.1 * rng.rand(FB, h, w)).astype(np.float32)
    fmaps = (0.1 * rng.randn(FB, h, w, 128)).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= 2)
    ii, jj = ii[keep], jj[keep]
    E = len(ii)
    net = (0.1 * rng.randn(E, h, w, 128)).astype(np.float32)
    inp = (0.1 * rng.randn(E, h, w, 128)).astype(np.float32)
    target, _ = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(INTR),
        jnp.asarray(ii), jnp.asarray(jj))
    target = (np.asarray(target)
              + 0.1 * rng.randn(E, h, w, 2)).astype(np.float32)
    return dict(FB=FB, poses=poses, disps=disps, uncert=uncert, mono=mono,
                fmaps=fmaps, ii=ii, jj=jj, net=net, inp=inp, target=target,
                weight=np.zeros((E, h, w, 2), np.float32),
                damping=np.full((FB, h, w), 1e-6, np.float32))


def port_track_step(p, model, mesh, pmax=8, t0=1, t1=8):
    """The port's sharded step on p; per-edge outputs in the original edge
    order (read back through the permutation)."""
    FB, E = p["FB"], len(p["ii"])
    h, w = H, W
    meta = tsdba.shard_edges_by_frame(p["ii"], p["jj"], mesh.size, FB,
                                      degree=16)
    perm, ok = meta["perm"], meta["valid"]
    ii_t, jj_t = T(p["ii"], torch.int64), T(p["jj"], torch.int64)
    fm = T(p["fmaps"])
    packed = tcorr.pack_pyramid(tcorr.corr_pyramid(fm[ii_t], fm[jj_t]))
    g = tsdba.gather_edges([T(p["net"]), T(p["inp"]), T(p["target"]),
                            T(p["weight"]), ii_t, jj_t], perm)
    sh = [col.shard_rows(x, mesh.devices) for x in g]
    valid = col.shard_rows(torch.as_tensor(ok.reshape(-1)), mesh.devices)
    corr = [packed[torch.as_tensor(perm[d][ok[d]], dtype=torch.int64)]
            for d in range(mesh.size)]
    step = tst.make_sharded_track_step(mesh, FB, (h, w), pmax, iters=2)
    out = step(model, T(p["poses"]), T(p["disps"]),
               torch.zeros(FB, 8 * h, 8 * w), T(INTR), T(p["uncert"]),
               T(p["mono"]), torch.ones(FB, h, w, dtype=torch.bool), *sh[:4],
               corr, sh[4], sh[5], valid, valid, T(p["damping"]),
               meta["groups"], meta["owner"], t0, t1)
    flat = perm.reshape(-1)[ok.reshape(-1)]
    edges = []
    for xs in out[:3]:
        x = col.unshard_rows(xs, torch.device("cpu"))[
            torch.as_tensor(np.where(ok.reshape(-1))[0])]
        edges.append(x[torch.as_tensor(np.argsort(flat))])
    return edges, out[3:]


def test_sharded_track_step_matches_single_device_graph():
    """The smaller case (no JAX compile): the port's FactorGraph.update_n
    with an 8- and a 3-shard mesh against the same graph without one, two
    updates with inactive edges in the BA."""
    import sys
    sys.path.insert(0, "tests")
    from test_torch_frontend import synth_image
    from wildgs_slam_tpu_torch.slam.factor_graph import FactorGraph
    from wildgs_slam_tpu_torch.slam.motion_filter import MotionFilter

    cfg = tload_config("configs/wildgs_slam.yaml")
    model = tdn.init_droid_net(torch.Generator().manual_seed(0), device="cpu")
    HT, WD = 48, 64
    runs = []
    for mesh in (None, cpu_mesh(8), cpu_mesh(3)):
        st = TState.create(cfg, HT, WD, np.array([40.0, 40.0, 32.0, 24.0]),
                           buffer=32, device="cpu")
        mf = MotionFilter(st, model, thresh=-1.0, depth_fn=lambda im: np.full(
            (HT, WD), 2.0, np.float32))
        for t in range(6):
            mf.track(float(t), synth_image(t))
        g = FactorGraph(st, model, max_factors=48, mesh=mesh)
        g.add_neighborhood_factors(0, 6, r=2)
        g.update(1, use_inactive=True)
        drop = np.zeros(g.E, bool)
        drop[:4] = True
        g.rm_factors(drop, store=True)
        # the sharded path ignores eps (as the JAX one): n steps, NaN delta
        n_done, dmean = g.update_n(2, use_inactive=True,
                                   eps=0.0 if mesh is None else 1e9)
        assert n_done == 2
        assert bool(torch.isnan(dmean)) == (mesh is not None)
        runs.append((st.store.poses, st.store.disps, st.store.disps_up,
                     g.net, g.target, g.weight, g.damping))
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            close(a, b, 1e-5, 1e-4)


def test_sharded_track_step_matches_jax():
    need_devices()
    p = track_problem()
    FB, pmax, t0, t1 = p["FB"], 8, 1, 8
    h, w = H, W
    params = jdn.init_droid_params(jax.random.PRNGKey(1), h * 8, w * 8)
    model = tdn.DroidNet()
    model.load_state_dict(convert.droid_params_from_jax(
        jax.tree.map(np.asarray, params)))
    model.eval()

    iid, jjd = jnp.asarray(p["ii"]), jnp.asarray(p["jj"])
    fm = jnp.asarray(p["fmaps"])
    pyr = jcorr.corr_pyramid(fm[iid], fm[jjd])
    E = len(p["ii"])
    jm = jmesh.make_mesh(ND, axis="edge")
    meta = jsdba.shard_edges_by_frame(p["ii"], p["jj"], ND, FB, degree=16)
    g = jsdba.gather_edges([p["net"], p["inp"], p["target"], p["weight"],
                            *pyr, iid, jjd, np.ones(E, bool)], meta["perm"])
    vv = g[-1] & jnp.asarray(meta["valid"].reshape(-1))
    fn = jst.make_sharded_track_step(jm, FB, (h, w), meta["e_cap"], pmax,
                                     degree=16, iters=2)
    jout = fn(params, jnp.asarray(p["poses"]), jnp.asarray(p["disps"]),
              jnp.zeros((FB, h * 8, w * 8)), jnp.asarray(INTR),
              jnp.asarray(p["uncert"]), jnp.asarray(p["mono"]),
              jnp.ones((FB, h, w), bool), *g[:8], g[8], g[9], vv, vv,
              jnp.int32(0), jnp.asarray(p["damping"]),
              jnp.asarray(meta["groups"]), jnp.asarray(meta["owner"]),
              jnp.int32(t0), jnp.int32(t1))
    perm, ok = meta["perm"].reshape(-1), meta["valid"].reshape(-1)
    j_edges = [np.asarray(x)[ok][np.argsort(perm[ok])] for x in jout[:3]]

    for mesh in (cpu_mesh(axis="edge"), cpu_mesh(1, axis="edge")):
        edges, (damp, poses, disps, disps_up) = port_track_step(
            p, model, mesh, pmax, t0, t1)
        close(poses, jout[4], 1e-5, 1e-4)
        close(disps, jout[5], 1e-5, 1e-4)
        close(damp, jout[3], 1e-6, 1e-4)
        close(disps_up, jout[6], 1e-5, 1e-4)
        for name, a, b in zip(("net", "target", "weight"), edges, j_edges):
            close(a, b, 1e-5, 1e-4, name)


# ---------------------------------------------------------------------------
# sharded rasterizer
# ---------------------------------------------------------------------------

RH, RW = 32, 64     # 2 x 4 = 8 tiles over 8 shards
RINTR = np.array([50.0, 50.0, RW / 2, RH / 2], np.float32)
NG = 512
CAP_LOC = 32        # merged capacity 8 x 32 = 256


def raster_scene(seed=0):
    rng = np.random.RandomState(seed)
    means = np.concatenate([rng.uniform(-1, 1, (NG, 2)),
                            1.5 + 2 * rng.uniform(size=(NG, 1))], -1)
    scales = 0.02 + 0.05 * rng.uniform(size=(NG, 3))
    rots = rng.normal(size=(NG, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    opac = 0.3 + 0.6 * rng.uniform(size=NG)
    sh = rng.uniform(size=(NG, 1, 3))
    alive = rng.uniform(size=NG) > 0.1
    return [a.astype(np.float32) for a in (means, scales, rots, opac, sh)] + [
        alive]


def loss_of(out, wc):
    return ((out.color * wc).sum() + 0.5 * out.depth.sum()
            + 0.25 * out.alpha.sum())


def test_sharded_render_forward_and_gradients():
    need_devices()
    means, scales, rots, opac, sh, alive = raster_scene(1)
    w2c = se3_exp([0.0, 0.01, 0.0, -0.01, 0.0, 0.01])
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wc = np.random.RandomState(3).uniform(size=(RH, RW, 3)).astype(
        np.float32)

    jm = jmesh.make_mesh(ND, axis="g")
    jfn = jsr.make_sharded_render(jm, (RH, RW), capacity_local=CAP_LOC,
                                  chunk=32)

    def jloss(m, s, o, c, pd):
        out = jfn(m, s, jnp.asarray(rots), o, c, jnp.asarray(w2c),
                  jnp.asarray(RINTR), pose_delta=pd, alive=jnp.asarray(alive),
                  bg=jnp.asarray(bg))
        return loss_of(out, jnp.asarray(wc)), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        *map(jnp.asarray, (means, scales, opac, sh)), jnp.zeros(6))
    assert int(jout.overflow) == 0

    tfn = tsr.make_sharded_render(cpu_mesh(), (RH, RW),
                                  capacity_local=CAP_LOC, chunk=32)

    def port(fn):
        leaves = [T(a).requires_grad_(True) for a in (means, scales, opac,
                                                      sh)]
        pd = torch.zeros(6, requires_grad=True)
        out = fn(leaves[0], leaves[1], T(rots), leaves[2], leaves[3],
                 T(w2c), T(RINTR), pose_delta=pd, alive=T(alive, torch.bool),
                 bg=T(bg))
        grads = torch.autograd.grad(loss_of(out, T(wc)), leaves + [pd])
        return out, grads
    out, grads = port(tfn)
    ref, ref_grads = port(lambda *a, **k: tr.render_fused(
        *a[:7], (RH, RW), capacity=ND * CAP_LOC, chunk=32, **k))
    assert int(out.overflow) == 0 and int(ref.overflow) == 0
    for k in ("color", "depth", "alpha"):
        close(getattr(out, k).detach(), getattr(jout, k), 2e-5, 1e-4, k)
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    assert torch.equal(out.radii, ref.radii)
    names = ["means", "scales", "opacity", "sh", "pose_delta"]
    for name, a, jg, r in zip(names, grads, jgrads, ref_grads):
        close(a, jg, 5e-4, 1e-3, f"gradient vs JAX: {name}")
        close(a, r, 5e-4, 1e-3, f"gradient vs render_fused: {name}")
