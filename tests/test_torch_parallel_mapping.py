"""The port's multi-device mode on the mapping side, as
``tests/test_multichip.py``'s mapping cases: the Gaussian/tile-sharded
render of an image whose tile count does not divide the shards, the
mapper's ``_opt_segment`` rendering through it, and the data-parallel
train step; each held against the JAX package's sharded function on
conftest's 8-device CPU mesh and against the port's single-device path.
Tolerances are test_multichip.py's (see test_torch_parallel.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_parallel import (CAP_LOC, ND, NG, RH, RINTR, RW, T, close,
                                 cpu_mesh, need_devices, raster_scene,
                                 se3_exp)
from wildgs_slam_tpu.models.uncertainty import UncertaintyMLP as JMLP
from wildgs_slam_tpu.parallel import mesh as jmesh
from wildgs_slam_tpu.slam import gaussian_map as jgm
from wildgs_slam_tpu.slam import mapper as jmapper
from wildgs_slam_tpu.slam import viewpoints as jvp
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.models.uncertainty import UncertaintyMLP as TMLP
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.parallel import mesh as tmesh
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.slam import viewpoints as tvp
from wildgs_slam_tpu_torch.slam.mapper import Mapper as TMapper
from wildgs_slam_tpu_torch.slam.state import SlamState as TState

torch.set_num_threads(1)


def scene_map(n_cap=NG, seed=2):
    """raster_scene packed into fixed-capacity maps of both packages."""
    means, scales, rots, opac, sh, alive = raster_scene(seed)
    rot_wxyz = np.concatenate([rots[:, 3:4], rots[:, :3]], -1)
    logit = np.log(opac / (1 - opac))[:, None]
    jmap = jgm.create(n_cap, max_sh_degree=0)
    jmap = jmap._replace(
        params=jmap.params._replace(
            xyz=jmap.params.xyz.at[:NG].set(means),
            f_dc=jmap.params.f_dc.at[:NG].set(sh),
            opacity=jmap.params.opacity.at[:NG].set(logit),
            scaling=jmap.params.scaling.at[:NG].set(np.log(scales)),
            rotation=jmap.params.rotation.at[:NG].set(rot_wxyz)),
        aux=jmap.aux._replace(alive=jmap.aux.alive.at[:NG].set(alive),
                              kf_id=jmap.aux.kf_id.at[:NG].set(0)))
    tmap = tgm.create(n_cap, max_sh_degree=0, device="cpu")
    for name in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        getattr(tmap.params, name).copy_(T(np.asarray(getattr(jmap.params,
                                                               name))))
    tmap.aux.alive.copy_(T(np.asarray(jmap.aux.alive), torch.bool))
    tmap.aux.kf_id.copy_(T(np.asarray(jmap.aux.kf_id), torch.int32))
    return jmap, tmap


def test_gsharded_render_pad_and_mask():
    """A tile count that does not divide the shards (3 x 3 = 9 tiles at
    40x48) renders padded and cropped, equal to the single render."""
    need_devices()
    H2, W2 = 40, 48
    intr = np.array([40.0, 40.0, W2 / 2, H2 / 2], np.float32)
    jmap, tmap = scene_map()
    w2c = se3_exp([0.01, 0.0, 0.0, 0.0, 0.01, 0.0])
    jfn = jmesh.make_gsharded_render_fn(jmesh.make_mesh(ND, axis="g"),
                                        (H2, W2), capacity_local=2 * CAP_LOC,
                                        chunk=32)
    jout = jfn(jmap.params, jmap.aux.alive, jnp.asarray(w2c),
               jnp.asarray(intr))
    mesh = cpu_mesh()
    assert tmesh.pad_image_size_for_mesh((H2, W2), ND)[0] % 16 == 0
    tfn = tmesh.make_gsharded_render_fn(mesh, (H2, W2),
                                        capacity_local=2 * CAP_LOC, chunk=32)
    out = tfn(tmap.params, tmap.aux.alive, T(w2c), T(intr))
    p = tmap.params
    ref = tr.render_fused(p.xyz, tgm.get_scaling(p), tgm.get_rotation_xyzw(p),
                          tgm.get_opacity(p), tgm.get_sh(p), T(w2c), T(intr),
                          (H2, W2), capacity=ND * CAP_LOC, chunk=32,
                          alive=tmap.aux.alive)
    assert int(out.overflow) == 0 == int(jout.overflow) == int(ref.overflow)
    assert out.color.shape == (H2, W2, 3)
    close(out.color, jout.color, 2e-5, 1e-4)
    close(out.depth, jout.depth, 2e-4, 1e-4)
    close(out.color, ref.color, 2e-5, 1e-4)
    close(out.depth, ref.depth, 2e-4, 1e-4)


def opt_setup(render_list_capacity):
    """A port Mapper on the raster scene with test_multichip's view store
    (6 views, 4x4 features of 16 channels) and a converted 16-channel
    uncertainty MLP; the JAX segment's inputs beside it."""
    cfg = tload_config("configs/wildgs_slam.yaml")
    cfg["mapping"]["gaussian_capacity"] = NG
    cfg["mapping"]["render_list_capacity"] = render_list_capacity
    cfg["mapping"]["uncertainty_params"]["feature_dim"] = 16
    cfg["tracking"]["buffer"] = 6
    fh = fw = 4
    fd, B = 16, 6
    rng = np.random.RandomState(0)
    views = [(rng.rand(RH, RW, 3).astype(np.float32),
              (2.0 + 0.1 * rng.rand(RH, RW)).astype(np.float32),
              se3_exp(0.02 * rng.randn(6)),
              rng.rand(fh, fw, fd).astype(np.float32)) for _ in range(B)]
    u_params = JMLP(in_dim=fd).init(jax.random.PRNGKey(1), jnp.zeros((1, fd)))
    mlp = TMLP(fd)
    mlp.load_state_dict(convert.uncertainty_params_from_jax(
        jax.tree.map(np.asarray, u_params)))
    st = TState.create(cfg, RH, RW, RINTR / 8, buffer=B, device="cpu")
    m = TMapper(st, cfg, uncer_mlp=mlp, rng_seed=0, device="cpu")
    m.vstore = tvp.create(B, RH, RW, (fh, fw), fd, device="cpu")
    jvs = jvp.create(B, RH, RW, (fh, fw), fd)
    for i, (c, d, pose, f) in enumerate(views):
        tvp.set_view(m.vstore, i, T(c), T(d), T(pose), features=T(f))
        jvs = jvp.set_view(jvs, i, jnp.asarray(c), jnp.asarray(d),
                           jnp.asarray(pose), features=jnp.asarray(f))
    jmap, m.gaussians = scene_map()
    m.intrinsics_full = T(RINTR)
    return cfg, m, jmap, jvs, u_params


def test_gsharded_opt_segment_matches_jax_and_single():
    """Mapper._opt_segment rendering through the Gaussian/tile-sharded
    renderer against the JAX segment through its own, and against the
    port's segment with the single render; 4 steps, 2 of them frozen."""
    need_devices()
    K, B = 4, 6
    cfg, m_sh, jmap, jvs, u_params = opt_setup(ND * CAP_LOC)
    m_one = copy.deepcopy(m_sh)
    m_sh.iters_after_densify = m_one.iters_after_densify = 0
    # the draws the port's segment makes, handed to the JAX segment
    rng = copy.deepcopy(m_sh.rng)
    fh, fw = m_sh.vstore.features.shape[1:3]
    S = max(1, 5 * fh * fw // (m_sh.loss_cfg["uncertainty_params"][
        "reg_stride"] ** 4))
    idxs = rng.choice(np.arange(B), size=K)
    d_samples = rng.randint(0, 5 * fh * fw, size=(8, S))[:K]
    freeze = np.arange(K) < 2

    rfn = tmesh.make_gsharded_render_fn(cpu_mesh(), (RH, RW),
                                        capacity_local=CAP_LOC, chunk=32)
    ls_sh = m_sh._opt_segment(K, np.arange(B), None, 2, render_fn=rfn)
    ls_one = m_one._opt_segment(K, np.arange(B), None, 2)

    jm = jmesh.make_mesh(ND, axis="g")
    jrfn = jmesh.make_gsharded_render_fn(jm, (RH, RW),
                                         capacity_local=CAP_LOC, chunk=32)
    zeros = jax.tree.map(jnp.zeros_like, u_params)
    jout = jmapper._opt_segment(
        jmesh.shard_gaussian_map(jmap, jm), jvs, u_params, zeros, zeros,
        jnp.zeros((), jnp.int32), jnp.asarray(RINTR), jnp.asarray(idxs),
        jnp.asarray(freeze), jnp.asarray(np.clip(idxs - 2, 0, B - 5)),
        jnp.asarray(d_samples), jnp.ones(K, bool), jnp.arange(K), None,
        (RH, RW), ND * CAP_LOC, 32, True, False, S,
        jmapper.HashableDict(m_sh.loss_cfg), render_fn=jrfn)

    close(ls_sh, np.asarray(jout[6]), 1e-6, 2e-4)
    close(ls_sh, ls_one, 1e-6, 2e-4)
    for name in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        a = getattr(m_sh.gaussians.params, name)
        close(a, np.asarray(getattr(jout[0].params, name)), 2e-3, 0,
              f"params.{name} vs JAX")
        close(a, getattr(m_one.gaussians.params, name), 2e-3, 0,
              f"params.{name} vs single")
    close(m_sh.vstore.exposure, np.asarray(jout[1].exposure), 1e-5, 0)
    close(m_sh.vstore.exposure, m_one.vstore.exposure, 1e-5, 0)
    j_mlp = convert.uncertainty_params_from_jax(jax.tree.map(np.asarray,
                                                             jout[2]))
    for name, p in m_sh.uncer_mlp.state_dict().items():
        close(p, j_mlp[name], 1e-5, 0, name)
        close(p, m_one.uncer_mlp.state_dict()[name], 1e-5, 0, name)


def test_sharded_train_step():
    """The data-parallel train step (each shard renders its own views from
    its copy of the map, gradients summed, one Adam step) against the same
    step with every view on one device, and the JAX multiview loss."""
    need_devices()
    jmap, tmap = scene_map()
    rng = np.random.RandomState(5)
    views = np.stack([se3_exp(0.02 * rng.randn(6)) for _ in range(ND)])
    gt_c = rng.rand(ND, RH, RW, 3).astype(np.float32)
    gt_d = np.full((ND, RH, RW), 2.0, np.float32)
    jl = jmesh.multiview_loss(jmap.params, jmap.aux, jnp.asarray(views),
                              jnp.asarray(gt_c), jnp.asarray(gt_d),
                              jnp.asarray(RINTR), (RH, RW), 256, 32)
    lrs = dict.fromkeys(tgm.PARAM_NAMES, 0.01)
    maps = []
    for mesh in (cpu_mesh(axis="view"), cpu_mesh(1, axis="view")):
        m = copy.deepcopy(tmap)
        step = tmesh.make_sharded_train_step(mesh, T(RINTR), (RH, RW), lrs,
                                             capacity=256, chunk=32)
        m, loss = step(m, T(views), T(gt_c), T(gt_d))
        close(loss, float(jl), 1e-6, 1e-5)
        maps.append(m)
    for name in tgm.PARAM_NAMES:
        close(getattr(maps[0].params, name), getattr(maps[1].params, name),
              1e-6, 1e-5, name)
    assert float((maps[0].params.xyz - tmap.params.xyz).abs().max()) > 0


def test_mapper_mesh_of_five():
    """The mapper in mesh mode on 5 shards, which divide neither the
    capacity nor the tiles: its capacity is padded to a multiple of 5, its
    per-shard lists merge to whole 64-slot chunks, and its sharded renderer
    (image padded, culled at the true size) equals render_fused."""
    cfg = tload_config("configs/wildgs_slam.yaml")
    cfg["mapping"]["gaussian_capacity"] = NG
    cfg["mapping"]["render_list_capacity"] = 256
    cfg["tracking"]["buffer"] = 2
    st = TState.create(cfg, RH, RW, RINTR / 8, buffer=2, device="cpu")
    m = TMapper(st, cfg, rng_seed=0, device="cpu", mesh=cpu_mesh(5))
    assert m.capacity == 515 and m.gaussians.capacity == 515
    _, tmap = scene_map(n_cap=515)
    w2c = T(se3_exp([0.01, -0.02, 0.0, 0.02, 0.0, 0.01]))
    out = m.mesh_render_fn(tmap.params, tmap.aux.alive, w2c, T(RINTR))
    p = tmap.params
    ref = tr.render_fused(p.xyz, tgm.get_scaling(p), tgm.get_rotation_xyzw(p),
                          tgm.get_opacity(p), tgm.get_sh(p), w2c, T(RINTR),
                          (RH, RW), capacity=256, chunk=64,
                          alive=tmap.aux.alive)
    assert int(out.overflow) == 0 == int(ref.overflow)
    assert out.color.shape == (RH, RW, 3)
    for k in ("color", "depth", "alpha"):
        close(getattr(out, k), getattr(ref, k), 2e-5, 1e-4, k)
    assert torch.equal(out.radii, ref.radii)
