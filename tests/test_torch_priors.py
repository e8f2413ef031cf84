"""The port's prior networks and predictors against the JAX package's, with
weights made from a seed (torch ``state_dict``s in upstream names, read by
both packages' loaders, or flax trees carried by ``convert``).

Tolerances, and why:
- DINOv2 (width 64, depth 2, 2 heads, base grid 4; with and without
  registers; native and resized grids): patch and class tokens atol 2e-5
  (measured <= 3e-6: float32 matmuls summed in another order); the
  converters return the loaders' inputs exactly;
- the positional-embedding resize alone against ``jax.image.resize``
  (bicubic), shrinking and enlarging: atol 1e-6 (measured < 1e-7);
- DepthAnythingV2("vits") at 70x98: depth (metres, up to 20) atol 1e-4
  (measured 1.6e-5 after 12 blocks and the fusion head);
- the resizes against cv2 on float32 images in [0, 1]: INTER_AREA (shrink
  and the two enlargements the priors make) atol 1e-6, INTER_CUBIC atol
  1e-4 (cv2's float path differs by up to 3e-5); uint8 INTER_LINEAR within
  one level; INTER_NEAREST equal;
- the predictors end to end: features atol 2e-5, depth atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cv2
import flax.linen as fnn

from wildgs_slam_tpu.models import dinov2 as jd
from wildgs_slam_tpu.models import dpt as jdpt
from wildgs_slam_tpu.models import priors as jpri
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.models import dinov2 as td
from wildgs_slam_tpu_torch.models import dpt as tdpt
from wildgs_slam_tpu_torch.models import priors as tpri
from wildgs_slam_tpu_torch.utils import resample as rs

torch.set_num_threads(2)
SMALL = dict(embed_dim=64, depth=2, num_heads=2, base_grid=4)


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


def seeded_(module, seed, std=0.05):
    """Every parameter of `module` drawn from N(0, std) (LayerScale and norm
    scales around 1), from a torch.Generator; the unused mask token stays
    zero, as the JAX package has none."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("mask_token"):
                continue
            noise = torch.randn(p.shape, generator=gen) * std
            base = 1.0 if name.endswith(("gamma", "norm1.weight",
                                         "norm2.weight", "norm.weight")) \
                else 0.0
            p.copy_(base + noise)
    return module.eval()


# ---------------------------------------------------------------------------
# DINOv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_reg", [0, 4])
def test_dinov2_follows_flax(n_reg):
    """Seeded weights through the JAX package's loader into the flax module
    and back through the port's converter (which must return them)."""
    sd = seeded_(td.DINOv2(num_register_tokens=n_reg, **SMALL), seed=n_reg
                 ).state_dict()
    params = jd.load_torch_dinov2({k: v.numpy() for k, v in sd.items()})
    back = convert.dinov2_state_from_jax(jax.tree.map(np.asarray, params))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    tm = td.DINOv2(num_register_tokens=n_reg, **SMALL).eval()
    tm.load_state_dict(back)
    jm = jd.DINOv2(num_register_tokens=n_reg, **SMALL)
    rng = np.random.RandomState(1)
    # the native 4x4 grid, then a 3x5 grid resized from it (one axis
    # shrinks, the other grows)
    for shape in [(1, 56, 56, 3), (2, 42, 70, 3)]:
        x = rng.normal(size=shape).astype(np.float32)
        outs_j = jm.apply({"params": params}, jnp.asarray(x),
                          out_layers=(0, 1))
        with torch.no_grad():
            outs_t = tm(torch.from_numpy(x), out_layers=(0, 1))
        for (pj, cj), (pt, ct) in zip(outs_j, outs_t):
            close(pt, pj, 2e-5)
            close(ct, cj, 2e-5)


@pytest.mark.parametrize("grid,size", [(37, (27, 36)), (37, (44, 76)),
                                       (37, (37, 37)), (4, (2, 9))])
def test_pos_embed_resize_equals_jax_image_resize(grid, size):
    x = np.random.RandomState(grid).normal(
        0, 0.02, (grid, grid, 32)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x)[None], (1, *size, 32), "bicubic")[0]
    close(rs.resize(torch.from_numpy(x), size, "jax_cubic"), ref, 1e-6)


def upstream_pos_embed_resize(grid_hw_c, ph, pw, offset=0.1):
    """Upstream DINOv2's interpolate_pos_encoding: F.interpolate bicubic
    (a = -0.75, no antialias) with the scale factor (n + 0.1) / M."""
    M = grid_hw_c.shape[0]
    g = torch.from_numpy(grid_hw_c).permute(2, 0, 1)[None]
    out = F.interpolate(g, mode="bicubic", antialias=False,
                        scale_factor=((ph + offset) / M, (pw + offset) / M))
    assert out.shape[-2:] == (ph, pw)
    return out[0].permute(1, 2, 0).numpy()


@pytest.mark.parametrize("size", [(27, 36), (44, 76)])
def test_pos_embed_resize_differs_from_upstream_in_both_packages(size):
    """ROADMAP Queue 3 (b): the port resizes as the JAX package does, and
    both differ from upstream DINOv2's F.interpolate on the same grid (a
    seeded N(0, 0.02) stand-in for the pretrained embedding)."""
    x = np.random.RandomState(0).normal(0, 0.02, (37, 37, 64)).astype(
        np.float32)
    port = rs.resize(torch.from_numpy(x), size, "jax_cubic").numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x)[None], (1, *size, 64),
                                      "bicubic")[0])
    close(port, ref, 1e-6)
    diff = np.abs(port - upstream_pos_embed_resize(x, *size)).max()
    assert diff > 1e-3, diff      # ~10% of the values' spread


# ---------------------------------------------------------------------------
# DepthAnythingV2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def da2_state():
    """A seeded DepthAnythingV2("vits") state_dict in upstream names."""
    return {k: v.clone() for k, v in seeded_(tdpt.DepthAnythingV2(
        "vits", 20.0), seed=3, std=0.02).state_dict().items()}


def test_depth_anything_follows_flax(da2_state):
    params = jdpt.load_torch_depth_anything(
        {k: v.numpy() for k, v in da2_state.items()}, encoder="vits")
    # the converter is the loader's inverse
    back = convert.depth_anything_state_from_jax(
        jax.tree.map(np.asarray, params))
    assert back.keys() == da2_state.keys()
    for k, v in da2_state.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    tm = tdpt.DepthAnythingV2("vits", 20.0).eval()
    tm.load_state_dict(back)
    x = np.random.RandomState(2).normal(size=(1, 70, 98, 3)).astype(
        np.float32)
    ref = jdpt.DepthAnythingV2(encoder="vits", max_depth=20.0).apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (1, 70, 98)
    close(out, ref, 1e-4)


# ---------------------------------------------------------------------------
# the resizes the priors and the readers make with cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst,mode,flag,atol", [
    ((384, 512), (378, 504), "area", cv2.INTER_AREA, 1e-6),     # DINO
    ((384, 512), (518, 686), "area", cv2.INTER_AREA, 1e-6),     # DA2
    ((384, 512), (616, 812), "area", cv2.INTER_AREA, 1e-6),     # Metric3D
    ((48, 64), (24, 30), "area", cv2.INTER_AREA, 1e-6),
    ((616, 812), (384, 512), "cubic", cv2.INTER_CUBIC, 1e-4),
    ((518, 686), (384, 512), "cubic", cv2.INTER_CUBIC, 1e-4),
    ((30, 40), (48, 64), "cubic", cv2.INTER_CUBIC, 1e-4),
])
def test_resize_equals_cv2(src, dst, mode, flag, atol):
    x = np.random.RandomState(0).rand(*src, 3).astype(np.float32)
    ref = cv2.resize(x, dst[::-1], interpolation=flag)
    out = rs.resize(torch.from_numpy(x), dst, mode)
    close(out, ref, atol)


def test_uint8_linear_and_nearest_resize_equal_cv2():
    rng = np.random.RandomState(1)
    u8 = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    d = np.abs(rs.resize_u8(u8, (400, 528)).astype(int)
               - cv2.resize(u8, (528, 400)))
    assert d.max() <= 1
    depth = rng.rand(480, 640).astype(np.float32)
    np.testing.assert_array_equal(
        rs.resize_nearest(depth, (400, 528)),
        cv2.resize(depth, (528, 400), interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------------------------------
# predictors end to end
# ---------------------------------------------------------------------------

def eager(pred, model_apply):
    """The JAX predictor's network un-jitted (a test-side wrapper; its
    compile would take longer than the forward on these sizes)."""
    pred._apply = model_apply


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory, da2_state):
    d = tmp_path_factory.mktemp("pretrained")
    torch.save(da2_state, d / "depth_anything_v2_metric_hypersim_vits.pth")
    dino = seeded_(td.make_dinov2("vits", num_register_tokens=4), seed=5,
                   std=0.02)
    torch.save(dino.state_dict(), d / "fit3d_dinov2_reg_small_fine.pth")
    return str(d)


def test_depth_anything_predictor(ckpt_dir):
    img = np.random.RandomState(4).rand(48, 64, 3).astype(np.float32)
    jp = jpri.DepthAnythingPredictor("dpt2_vits_hypersim_20", ckpt_dir,
                                     input_size=56)
    eager(jp, lambda p, x: jp.model.apply({"params": p}, x))
    tp = tpri.DepthAnythingPredictor("dpt2_vits_hypersim_20", ckpt_dir,
                                     input_size=56, device="cpu")
    ref, out = jp(img), tp(img)
    assert out.shape == (48, 64) and out.dtype == np.float32
    close(out, ref, 1e-4)


class ConstDepth(fnn.Module):
    """A tiny trunk for the Metric3D protocol: depth from a 1x1 map of the
    normalized image."""

    @fnn.compact
    def __call__(self, x):
        w = self.param("w", lambda k: jnp.array([300.0, -200.0, 100.0]))
        return jax.nn.softplus(x @ w) + 500.0


class TorchConstDepth(torch.nn.Module):
    def forward(self, x):
        w = torch.tensor([300.0, -200.0, 100.0])
        return F.softplus(x @ w) + 500.0


def test_metric3d_protocol():
    img = np.random.RandomState(6).rand(96, 128, 3).astype(np.float32)
    trunk = ConstDepth()
    params = trunk.init(jax.random.PRNGKey(0), jnp.zeros((1, 14, 14, 3)))[
        "params"]
    for fx in (300.0, 700.0):   # the second clamps part of the map at 300 m
        jp = jpri.Metric3DPredictor("metric3d_vit_small", fx=fx, trunk=trunk,
                                    trunk_params=params)
        tp = tpri.Metric3DPredictor("metric3d_vit_small", fx=fx,
                                    trunk=TorchConstDepth(), device="cpu")
        ref, out = jp(img), tp(img)
        assert out.shape == (96, 128)
        close(out, ref, 1e-4, rtol=1e-6)


def test_feature_predictor_and_cache(ckpt_dir, tmp_path):
    img = np.random.RandomState(8).rand(48, 64, 3).astype(np.float32)
    jp = jpri.Fit3DFeaturePredictor("dinov2_reg_small_fine", ckpt_dir)
    eager(jp, lambda p, x: jp.model.apply({"params": p}, x)[0][0])
    tp = tpri.Fit3DFeaturePredictor("dinov2_reg_small_fine", ckpt_dir,
                                    device="cpu")
    ref, out = jp(img), tp(img)
    assert out.shape == (3, 4, 384)
    close(out, ref, 2e-5)

    # make_prior_fns builds both predictors from the checkpoints; the cache
    # names files by call count (ROADMAP Queue 3 (a), as the JAX package)
    cfg = {"mono_prior": {"depth": "metric3d_vit_small",
                          "feature_extractor": "dinov2_reg_small_fine"},
           "cam": {"fx": 500.0}}
    depth_fn, feat_fn = tpri.make_prior_fns(cfg, str(tmp_path), ckpt_dir,
                                            device="cpu")
    assert isinstance(depth_fn.fn, tpri.Metric3DPredictor)
    f0 = feat_fn(img)
    close(f0, out, 0)
    other = np.zeros_like(img)
    f1 = feat_fn(other)
    assert sorted(p.name for p in (tmp_path / "mono_priors" / "features")
                  .iterdir()) == ["00000.npy", "00001.npy"]
    close(np.load(tmp_path / "mono_priors" / "features" / "00001.npy"), f1,
          0)
    # a fresh cache (a resumed run) starts its counter at 0 again, and so
    # reads frame 0's features for whatever image comes first
    jfeat = jpri.CachingPredictor(lambda im: None,
                                  str(tmp_path / "mono_priors" / "features"))
    tfeat = tpri.CachingPredictor(lambda im: None,
                                  str(tmp_path / "mono_priors" / "features"))
    close(jfeat(other), f0, 0)
    close(tfeat(other), f0, 0)
