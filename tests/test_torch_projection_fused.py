"""The render's projection (``projection_cuda.py``) on the CPU, where
``render_fused`` takes the plain projection: ``project_rows`` against
autograd of ``project_gaussians`` + ``pack_attrs`` with the rows' wiring
(offset, alive, radius, the binning's detached inputs, pose_delta) written
out, and against the JAX package's ``project_gaussians`` and ``jax.grad``.
The kernel pair P1/P2 itself runs on the card only
(``test_torch_kernels_gpu.py``); its wrappers refuse other tensors.

Scenes are drawn with numpy (``test_torch_kernels_gpu.projection_scene``)
and cull rows every way: behind the near plane, det <= 0 (needle-shaped
rows), out of the image and not alive.

Tolerances: the rows equal the plain projection's; the gradients within
max-relative 1e-5 of autograd's, as K2's; against the JAX package those of
test_torch_rasterizer.py (rtol / atol 1e-5 forward, radius and valid
equal, gradients max-relative 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.ops.rasterizer import projection as jproj
from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.ops.rasterizer import projection_cuda as pc
from wildgs_slam_tpu_torch.utils.profiling import TIMER
from test_torch_kernels_gpu import needle_rows, projection_scene

torch.set_num_threads(1)
H, W = 48, 64


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def inputs(s):
    t = torch.as_tensor
    return ([t(s[k]) for k in ("means", "scales", "rots", "opac", "sh")],
            t(s["w2c"]), t(s["intr"]), t(s["offset"]), t(s["alive"]))


@pytest.fixture(scope="module")
def culled():
    return projection_scene(4096, H, W, seed=7)


def cotangent(valid, seed):
    """Seeded cotangents on the valid rows but the needles (as a tile list
    gives them), zero elsewhere."""
    keep = valid & ~torch.as_tensor(needle_rows(valid.shape[0]))
    g = torch.randn(valid.shape[0], 16,
                    generator=torch.Generator().manual_seed(seed))
    return torch.where(keep[:, None], g, torch.zeros_like(g))


def autograd_grads(gauss, w2c, intr, off, g, pose, sm=1.0):
    """Gradients of sum(rows * g) through project_gaussians + pack_attrs:
    the five Gaussian inputs, the offset (or None) and pose_delta (or
    None)."""
    leaves = [x.clone().requires_grad_(True) for x in gauss]
    o = None if off is None else off.clone().requires_grad_(True)
    pd = torch.zeros(6, requires_grad=True) if pose else None
    proj = tr.project_gaussians(*leaves, w2c, intr, (H, W), pose_delta=pd,
                                scale_modifier=sm)
    mean2d = proj.mean2d if o is None else proj.mean2d + o
    (tr.pack_attrs(mean2d, proj) * g).sum().backward()
    return ([x.grad for x in leaves] + [None if o is None else o.grad]
            + [None if pd is None else pd.grad])


def function_grads(gauss, w2c, intr, off, alive, g, pose, sm=1.0):
    """The same through project_rows, render_fused's projection (on the CPU
    the plain projection under autograd); also its outputs."""
    leaves = [x.clone().requires_grad_(True) for x in gauss]
    o = None if off is None else off.clone().requires_grad_(True)
    pd = torch.zeros(6, requires_grad=True) if pose else None
    rows = pc.project_rows(*leaves, w2c, intr, (H, W), pose_delta=pd,
                           scale_modifier=sm, mean2d_offset=o, alive=alive)
    (rows.attrs * g).sum().backward()
    return ([x.grad for x in leaves] + [None if o is None else o.grad]
            + [None if pd is None else pd.grad]), rows


def test_scene_culls_every_way(culled):
    gauss, w2c, intr, _, alive = inputs(culled)
    proj = tr.project_gaussians(*gauss, w2c, intr, (H, W))
    conic_det = proj.conic[:, 0] * proj.conic[:, 2] - proj.conic[:, 1] ** 2
    near = proj.depth <= 0.2
    assert int(near.sum()) > 100
    assert int((conic_det <= 0).sum()) > 10
    assert int((~proj.valid & ~near & (conic_det > 0)).sum()) > 100
    assert int(proj.valid.sum()) > 1000
    assert int((proj.valid & ~alive).sum()) > 50


@pytest.mark.parametrize("pose", [False, True])
@pytest.mark.parametrize("use_alive", [False, True])
@pytest.mark.parametrize("use_offset", [False, True])
def test_plain_branch_matches_autograd(culled, use_offset, use_alive, pose):
    gauss, w2c, intr, off, alive = inputs(culled)
    off = off if use_offset else None
    alive = alive if use_alive else None
    ref = pc.project_fwd_plain(*gauss, w2c, intr, (H, W), off, alive)
    g = cotangent(ref.valid, seed=1)
    got, rows = function_grads(gauss, w2c, intr, off, alive, g, pose)
    want = autograd_grads(gauss, w2c, intr, off, g, pose)

    proj = tr.project_gaussians(*gauss, w2c, intr, (H, W))
    valid = proj.valid if alive is None else proj.valid & alive
    mean2d = proj.mean2d if off is None else proj.mean2d + off
    assert torch.equal(rows.attrs, tr.pack_attrs(mean2d, proj))
    assert torch.equal(rows.valid, valid)
    assert torch.equal(rows.radius,
                       torch.where(valid, proj.radius, torch.zeros_like(
                           proj.radius)))
    assert torch.equal(rows.mean2d, mean2d) and torch.equal(rows.depth,
                                                            proj.depth)
    assert not rows.mean2d.requires_grad and not rows.depth.requires_grad
    for name, a, b in zip(("means", "scales", "rots", "opac", "sh", "offset",
                           "pose"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert max_rel(a, b) < 1e-5, name


@pytest.mark.parametrize("sm", [0.6, 1.7])
def test_plain_branch_scale_modifier(culled, sm):
    gauss, w2c, intr, off, alive = inputs(culled)
    ref = pc.project_fwd_plain(*gauss, w2c, intr, (H, W), off, alive, sm)
    g = cotangent(ref.valid, seed=2)
    got, rows = function_grads(gauss, w2c, intr, off, alive, g, True, sm)
    want = autograd_grads(gauss, w2c, intr, off, g, True, sm)
    assert torch.equal(rows.attrs, ref.attrs)
    for a, b in zip(got, want):
        assert max_rel(a, b) < 1e-5


def test_project_rows_on_cpu_is_the_plain_projection(culled):
    """render_fused's projection on the CPU: the plain projection under
    autograd, no TIMER counter touched; the same rows as the Function."""
    gauss, w2c, intr, off, alive = inputs(culled)
    TIMER.reset()
    rows = pc.project_rows(*gauss, w2c, intr, (H, W), mean2d_offset=off,
                           alive=alive)
    ref = pc.project_fwd_plain(*gauss, w2c, intr, (H, W), off, alive)
    assert not TIMER.counters
    for a, b in zip(rows, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_other_devices(culled, device):
    """P1/P2 and ProjectRows take CUDA tensors only: no plain fallback."""
    gauss, w2c, intr, _, _ = inputs(culled)
    on = [x.to(device) for x in gauss]
    w2c, intr = w2c.to(device), intr.to(device)
    with pytest.raises(ValueError):
        pc.project_fwd(*on, w2c, intr, (H, W))
    with pytest.raises(ValueError):
        pc.project_bwd(*on[:3], on[4], torch.ones(4096, dtype=torch.bool,
                                                  device=device),
                       w2c, intr, (H, W), torch.zeros(4096, 16,
                                                      device=device))
    with pytest.raises(ValueError):
        pc.ProjectRows.apply(*on, w2c, intr, None, None, (H, W), 1.0)


def rasterizer_scene():
    """test_torch_rasterizer.py's scene (that of test_pallas_composite.py)
    in projection_scene's keys."""
    rng = np.random.RandomState(0)
    N = 200
    means = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                            2.0 + 2.0 * rng.uniform(size=(N, 1))], -1)
    scales = 0.02 + 0.08 * rng.uniform(size=(N, 3))
    rots = rng.normal(size=(N, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    opac = 0.3 + 0.6 * rng.uniform(size=N)
    sh = rng.uniform(size=(N, 1, 3))
    w2c = np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.015, 1.0])
    w2c[3:] /= np.linalg.norm(w2c[3:])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(means=f32(means), scales=f32(scales), rots=f32(rots),
                opac=f32(opac), sh=f32(sh), w2c=f32(w2c),
                intr=f32([55.0, 55.0, W / 2, H / 2]),
                offset=np.zeros((N, 2), np.float32),
                alive=np.ones(N, bool))


@pytest.mark.parametrize("pose", [False, True])
@pytest.mark.parametrize("which", ["rasterizer", "culled"])
def test_plain_branch_matches_jax(culled, which, pose):
    """Rows, radius and valid against the JAX project_gaussians, and the
    plain branch's gradients against jax.grad (no offset, all alive: the
    JAX function takes neither); the culled scene without its needle rows,
    whose det <= 0 comes from rounding."""
    s = rasterizer_scene() if which == "rasterizer" else dict(culled)
    if which == "culled":
        keep = ~needle_rows(s["means"].shape[0])
        s = {k: (v[keep] if k not in ("w2c", "intr") else v)
             for k, v in s.items()}
    args = [s[k] for k in ("means", "scales", "rots", "opac", "sh", "w2c",
                           "intr")]
    pj = jproj.project_gaussians(*map(jnp.asarray, args), (H, W))
    gauss, w2c, intr, _, _ = inputs(s)
    rows = pc.project_fwd_plain(*gauss, w2c, intr, (H, W))
    cols = {"mean2d": rows.attrs[:, 0:2], "conic": rows.attrs[:, 2:5],
            "color": rows.attrs[:, 5:8], "opacity": rows.attrs[:, 8],
            "depth": rows.attrs[:, 9]}
    for name, col in cols.items():
        np.testing.assert_allclose(col, getattr(pj, name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(rows.valid, pj.valid)
    np.testing.assert_array_equal(rows.radius, np.where(pj.valid, pj.radius,
                                                        0))

    g = cotangent(rows.valid, seed=4)
    gn = g.numpy()

    def jloss(m, sc, r, o, sh, pd):
        p = jproj.project_gaussians(m, sc, r, o, sh, *map(jnp.asarray,
                                                          args[5:]), (H, W),
                                    pose_delta=pd if pose else None)
        return (jnp.sum(p.mean2d * gn[:, 0:2]) + jnp.sum(p.conic * gn[:, 2:5])
                + jnp.sum(p.color * gn[:, 5:8]) + jnp.sum(p.opacity * gn[:, 8])
                + jnp.sum(p.depth * gn[:, 9]))
    gj = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args[:5]), jnp.zeros(6))
    got, _ = function_grads(gauss, w2c, intr, None, None, g, pose)
    for i, name in enumerate(("means", "scales", "rots", "opac", "sh")):
        assert max_rel(got[i], gj[i]) < 1e-5, name
    if pose:
        assert max_rel(got[6], gj[5]) < 1e-5
