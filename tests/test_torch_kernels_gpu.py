"""K1/K2 on the card against their plain PyTorch versions.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, never at import). Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: forward atol 1e-5 for colour, alpha, tfin and tentry, 1e-4 for
depth (values ~3), as in tests/test_pallas_composite.py; the kernels are
compiled with --fmad=false and round op by op as the plain versions do, so
what remains is the order of the per-pixel and per-slot sums. Gradients:
max-relative error (max |a - b| / max |b|) below 1e-5.
"""

import numpy as np
import pytest
import torch

from wildgs_slam_tpu_torch.ops import rasterizer as tr
from wildgs_slam_tpu_torch.ops.rasterizer import composite_cuda as cc

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _table(n, h, w, capacity, seed, dev):
    """A packed table from the port's projection and binning of a seeded
    random scene of n Gaussians in front of an h x w camera."""
    rng = np.random.RandomState(seed)
    f = 0.9 * w
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 1)) * w / f,
                            rng.uniform(-1.2, 1.2, (n, 1)) * h / f,
                            np.ones((n, 1))], -1)
    means *= 2.0 + 3.0 * rng.uniform(size=(n, 1))
    scales = np.exp(rng.uniform(np.log(0.005), np.log(0.05), (n, 3)))
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    proj = tr.project_gaussians(
        t(means), t(scales), t(rots), t(0.2 + 0.75 * rng.uniform(size=n)),
        t(rng.uniform(-1, 1, (n, 1, 3))), t([0, 0, 0, 0, 0, 0, 1]),
        t([f, f, w / 2, h / 2]), (h, w))
    bins = tr.bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.valid,
                            (h, w), capacity=capacity)
    z = torch.zeros_like(proj.depth)
    attrs = torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                         proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
                         proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
                         proj.opacity, proj.depth] + [z] * 6, 1)
    return bins.counts, tr.gather_table(attrs, bins.ids).contiguous()


def _max_rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


@pytest.mark.parametrize("n,h,w,capacity", [(300, 48, 64, 128),
                                            (131072, 384, 512, 512)])
def test_kernels_match_plain(n, h, w, capacity):
    _need_card()
    dev = torch.device("cuda")
    counts, table = _table(n, h, w, capacity, 0, dev)
    tw = -(-w // 16)
    T = table.shape[0]
    assert T == (-(-h // 16)) * tw
    tid = torch.arange(T, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.5, 0.9], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    gc = torch.randn(T, 256, 3, device=dev, generator=g)
    gd, ga, gt = (torch.randn(T, 256, device=dev, generator=g)
                  for _ in range(3))

    k_out = cc.composite_fwd(counts, tid, table, bg, tw, 64)
    p_out = cc.composite_fwd_plain(counts, tid, table, bg, tw, 64)
    for name, a, b, tol in zip(("color", "depth", "alpha", "tfin", "tentry"),
                               k_out, p_out,
                               (1e-5, 1e-4, 1e-5, 1e-5, 1e-5)):
        err = float((a - b).abs().max())
        assert err <= tol, (name, err)

    args = (counts, tid, table, bg, p_out[4], p_out[3], gc, gd, ga, gt, tw,
            64)
    k_d = cc.composite_bwd(*args)
    p_d = cc.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    assert _max_rel(k_d, p_d) < 1e-5
    assert bool((k_d[..., 10:] == 0).all())


def test_render_fused_gradients_on_card():
    """The autograd wiring on the card: render_fused (kernels) against
    render_reference (the per-pixel oracle), forward and gradients."""
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    n, h, w = 200, 48, 64
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    means = t(np.concatenate([rng.uniform(-1, 1, (n, 2)),
                              2 + 2 * rng.uniform(size=(n, 1))], -1))
    scales = t(0.02 + 0.08 * rng.uniform(size=(n, 3)))
    rots = rng.normal(size=(n, 4))
    rots = t(rots / np.linalg.norm(rots, axis=-1, keepdims=True))
    opac = t(0.3 + 0.6 * rng.uniform(size=n))
    sh = t(rng.uniform(size=(n, 1, 3)))
    w2c = t([0, 0, 0, 0, 0, 0, 1])
    intr = t([55.0, 55.0, w / 2, h / 2])

    def grads(renderer, **kw):
        m = means.clone().requires_grad_(True)
        pd = torch.zeros(6, device=dev, requires_grad=True)
        out = renderer(m, scales, rots, opac, sh, w2c, intr, (h, w),
                       pose_delta=pd, **kw)
        ((out.color ** 2).sum() + 0.01 * (out.depth ** 2).sum()
         + 0.1 * (out.alpha ** 2).sum()).backward()
        return out, m.grad, pd.grad

    before = cc.composite_fwd.launches, cc.composite_bwd.launches
    of, gmf, gpf = grads(tr.render_fused, capacity=256, chunk=64)
    assert (cc.composite_fwd.launches, cc.composite_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    orf, gmr, gpr = grads(tr.render_reference)
    assert float((of.color - orf.color).abs().max()) < 1e-5
    assert float((of.depth - orf.depth).abs().max()) < 1e-4
    assert _max_rel(gmf, gmr) < 1e-5
    assert _max_rel(gpf, gpr) < 1e-5
