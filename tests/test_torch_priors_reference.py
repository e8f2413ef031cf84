"""The port's prior networks (``models/dinov2.py``, ``models/dpt.py``)
against the benchmark's plain reference (``h100_bench/reference/priors.py``)
on weights from the benchmark's seeded rule (``h100_bench/seeded_priors.py``),
at a small size: ViT width 64, 4 blocks, 2 heads, every layer tapped, DPT
features 16 (out channels 16, 32, 64, 64).

Tolerances, and why (relative norms of the difference, as the benchmark's
numbers):
- the ViT's tapped layers and features, with and without registers, at a
  grid larger than the positional embedding's 37x37 in one axis and smaller
  in the other, and at one smaller in both: 1e-5 (measured <= 8e-7, class
  tokens included: float32 sums in another order; the positional-embedding
  resize's weights are built in float64 by the reference, in float32 by the
  port);
- DepthAnythingV2's tapped layers and its head's map before the sigmoid:
  1e-5 (measured <= 1.6e-7 and <= 7.6e-7 after the head's convolutions).

Planted faults, each of which must read at least 10x the tolerance: a
block's second LayerScale dropped (measured 0.45), the positional embedding
resized by upstream's ``F.interpolate`` (1.4e-2), the input rounded to
TF32's 10-bit mantissa (2.1e-4). And the seeded rule leaves no block inert:
each block moves the residual stream by at least 1% of its norm (measured
22-23%).
"""

import pytest
import torch

from h100_bench import seeded_priors
from h100_bench.reference import priors as ref
from wildgs_slam_tpu_torch.models import dinov2, dpt

torch.set_num_threads(2)
SMALL = dict(embed_dim=64, depth=4, num_heads=2)
HEAD = (16, [16, 32, 64, 64])
LAYERS = (0, 1, 2, 3)
TOL = 1e-5
GRIDS = [(3, 52), (5, 3)]     # patch grids: one axis grows, both shrink


def rel(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


def image(grid, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, grid[0] * 14, grid[1] * 14, 3), generator=g)


def round_tf32(x):
    """float32 -> the nearest value with a 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@pytest.fixture(scope="module")
def small_depth():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(dinov2.CONFIGS, "small", SMALL)
        mp.setitem(dpt.HEAD_CHANNELS, "small", HEAD)
        mp.setitem(dpt.INTERMEDIATE_LAYER_IDX, "small", list(LAYERS))
        net = dpt.DepthAnythingV2("small", 20.0)
        w = seeded_priors.load(net, 3, seeded_priors.SALT_DEPTH, "cpu")
        yield net, w


def port_depth(net, x):
    """The port's tapped layers and pre-sigmoid map, by forward hooks as
    the benchmark's driver takes them."""
    got = {}
    hooks = [net.pretrained.register_forward_hook(
        lambda m, a, o: got.__setitem__("taps", [p for p, _ in o])),
        net.depth_head.scratch.output_conv2[2].register_forward_hook(
        lambda m, a, o: got.__setitem__("logit", o[:, 0]))]
    with torch.no_grad():
        got["depth"] = net(x)
    for h in hooks:
        h.remove()
    return got


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("n_reg", [0, 4])
def test_vit_matches_reference(n_reg, grid):
    net = dinov2.DINOv2(num_register_tokens=n_reg, **SMALL)
    w = seeded_priors.load(net, 5 + n_reg, seeded_priors.SALT_FEAT, "cpu")
    x = image(grid, n_reg)
    with torch.no_grad():
        port = net(x, out_layers=LAYERS)
    want = ref.vit(w, x, LAYERS, SMALL["num_heads"])
    for (p, pc), (r, rc) in zip(port, want):
        assert p.shape == (1, grid[0] * grid[1], 64)
        assert rel(p, r) < TOL and rel(pc, rc) < TOL
    assert rel(port[-1][0], ref.features(w, x, SMALL["num_heads"])) < TOL


@pytest.mark.parametrize("grid", GRIDS)
def test_depth_anything_matches_reference(small_depth, grid):
    net, w = small_depth
    x = image(grid, 11)
    port = port_depth(net, x)
    want = ref.depth_anything(w, x, LAYERS, SMALL["num_heads"])
    for p, r in zip(port["taps"], want["taps"]):
        assert rel(p, r) < TOL
    assert rel(port["logit"], want["logit"]) < TOL
    assert torch.allclose(port["depth"], want["depth"], atol=1e-4)
    # the sigmoid's input is spread, not saturated, on these weights
    assert 0.3 < float(want["logit"].std()) < 10.0


@pytest.mark.parametrize("fault", ["ls2_dropped", "upstream_pos_resize",
                                   "input_tf32"])
def test_planted_faults_fail(small_depth, fault):
    net, w = small_depth
    x = image(GRIDS[0], 12)
    port = port_depth(net, x)
    kw, xr = {}, x
    if fault == "ls2_dropped":
        kw["w"] = dict(w, **{"pretrained.blocks.1.ls2.gamma": torch.ones(64)})
    elif fault == "upstream_pos_resize":
        kw["pos_resize"] = ref.resize_pos_embed_upstream
    else:
        xr = round_tf32(x)
        assert 0 < rel(xr, x) < 1e-3
    want = ref.depth_anything(kw.pop("w", w), xr, LAYERS, SMALL["num_heads"],
                              **kw)
    gaps = [rel(p, r) for p, r in zip(port["taps"], want["taps"])]
    assert max(max(gaps), rel(port["logit"], want["logit"])) > 10 * TOL


def test_seeded_rule_moves_every_block(small_depth):
    _, w = small_depth
    streams = []
    ref.vit(w, image(GRIDS[1], 13), (3,), SMALL["num_heads"], "pretrained.",
            streams=streams)
    assert len(streams) == SMALL["depth"] + 1
    for a, b in zip(streams[:-1], streams[1:]):
        assert rel(b, a) >= 0.01
    # LayerScale gammas near LS_GAMMA, LayerNorm weights near 1, tokens
    # small: none of seeded.py's zeros
    assert abs(float(w["pretrained.blocks.0.ls1.gamma"].mean())
               - seeded_priors.LS_GAMMA) < 0.05
    assert abs(float(w["pretrained.norm.weight"].mean()) - 1.0) < 0.05
    assert 0.01 < float(w["pretrained.pos_embed"].std()) < 0.03
    assert float(w["pretrained.mask_token"].abs().max()) == 0.0
