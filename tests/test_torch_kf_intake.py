"""The keyframe priors on the benchmark, at a small CPU size: the
predictors' seam for built networks (``models/priors.py``), their spans and
counters, and the ``tum_dynamic_priors.kf_intake`` cell's files, driver and
metrics (``h100_bench/``).

Small size: the camera at 64x128; the depth network a DepthAnythingV2 of
width 64, 4 blocks, 2 heads, every layer tapped, DPT features 16, under a
canonical input of 84x140 (the 64x128 frame fits as 70x140 and is padded);
the feature network the ViT-S/14 with 4 registers at 2 blocks; 8 keyframe
slots. The published widths are checked on the meta device.

- ``BENCHMARK.json`` names the new configuration, traffic and limits, and
  they load; the configuration keeps the published priors and widths.
- ``make_prior_fns`` with built networks returns what it returns from
  checkpoints written from those networks (equal arrays), under the same
  cache names; without either it raises ``FileNotFoundError``.
- A keyframe's spans nest as the metrics read them, the counters count.
- The driver's window ends when the keyframe store is full, every frame a
  keyframe, and its run is ``correct``.
- Each of the six ``prior.*`` metrics reads a finite value from a small
  traced run.

No JAX here.
"""

import ast
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import run as hr
from h100_bench import seeded_priors
from h100_bench.drivers import kf_intake
from h100_bench.reference import priors as ref
from wildgs_slam_tpu_torch.models import dinov2, dpt, priors
from wildgs_slam_tpu_torch.utils.profiling import TIMER

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CELL = "tum_dynamic_priors.kf_intake"
METRICS = ("prior.depth_ms_per_kf", "prior.feat_ms_per_kf",
           "prior.host_ms_per_kf", "prior.encoder_mfu", "prior.head_mfu",
           "prior.device_idle")


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


@pytest.fixture(scope="module")
def small():
    """The program's and the reference's tables at the small size. This
    test process holds JAX (the root conftest imports it), so the run's
    check for loaded JAX modules is left to the card's runs and the import
    test below."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hr, "forbidden_modules", lambda: [])
        mp.setitem(dinov2.CONFIGS, "small",
                   dict(embed_dim=64, depth=4, num_heads=2))
        mp.setitem(dinov2.CONFIGS, "vits",
                   dict(embed_dim=384, depth=2, num_heads=6))
        mp.setitem(dpt.HEAD_CHANNELS, "small", (16, [16, 32, 64, 64]))
        mp.setitem(dpt.INTERMEDIATE_LAYER_IDX, "small", [0, 1, 2, 3])
        mp.setitem(priors.METRIC3D_STAND_IN, "metric3d_vit_large",
                   "dpt2_small_hypersim_20")
        mp.setattr(priors.Metric3DPredictor, "CANONICAL", (84, 140))
        mp.setitem(ref.INTERMEDIATE, "small", (0, 1, 2, 3))
        mp.setitem(ref.HEADS, "small", 2)
        yield


def config_file():
    return json.loads((ROOT / "h100_bench" / "configs" /
                       "tum_dynamic_priors.json").read_text())


def small_config():
    c = copy.deepcopy(config_file()["config"])
    c["cam"].update(H=64, W=128, H_out=64, W_out=128, H_edge=0, W_edge=0,
                    fx=80.0, fy=80.0, cx=64.0, cy=32.0)
    c["tracking"]["buffer"] = 8
    return c


def small_traffic(profile=True):
    t = json.loads((ROOT / "h100_bench" / "traffic" /
                    "kf_intake.json").read_text())
    t.update(warm_frames=2, check_within=3, check_keyframes=2,
             profile={"start": 1, "frames": 2} if profile else None)
    return t


def measure(trace, seconds):
    return hr.measure(hr.load_json(hr.ROOT, "BENCHMARK.json"), CELL, 2 ** 31
                      + 17, seconds, trace, "cpu", config=small_config(),
                      traffic=small_traffic(trace))


def test_files_load_from_the_benchmark():
    spec = hr.load_json(hr.ROOT, "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    assert conf["reduced"] == ["tracking", "mono_prior", "device"]
    f = config_file()
    assert f["reduced"] == conf["reduced"] and f["source"] == conf["source"]
    assert set(f["changes"]) == set(conf["reduced"])
    assert f["config"]["mono_prior"] == {
        "depth": "metric3d_vit_large",
        "feature_extractor": "dinov2_reg_small_fine"}
    mix = hr.load_json(hr.HERE, "traffic", f"{cell['traffic']}.json")
    assert mix["driver"] == "kf_intake" and mix["force_keyframe_every"] == 1
    limits = hr.load_json(hr.HERE, "limits", f"{CELL}.json")
    assert set(limits) == {"encoder_gap", "depth_logit_gap", "feat_gap"}
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in METRICS:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "track_ms_per_frame"


def test_new_harness_files_import_no_jax():
    """The reference imports nothing of the program or JAX; the driver,
    the seeded rule, the counts and the metrics nothing of JAX or the JAX
    package (whole top-level names)."""
    jax = {"jax", "jaxlib", "flax", "wildgs_slam_tpu"}
    bench = ROOT / "h100_bench"
    assert not top_imports(bench / "reference" / "priors.py") & (
        jax | {"wildgs_slam_tpu_torch", "."})
    files = [bench / "drivers" / "kf_intake.py", bench / "seeded_priors.py",
             bench / "counts" / "priors.py"] + [
        bench / "metrics" / f"{m}.py" for m in METRICS]
    for f in files:
        assert not top_imports(f) & jax, f


def test_published_widths_are_built():
    """The networks the driver builds for the configuration, on the meta
    device, against the file's ``networks``: ViT-L/14 24 x 1024 with 16
    heads, DPT 256 / [256, 512, 1024, 1024], ViT-S/14 with 4 registers."""
    f = config_file()
    nets = f["networks"]
    with torch.device("meta"):
        encoder = kf_intake._encoder(f["config"])
        depth = dpt.DepthAnythingV2(encoder, 20.0)
        feat = dinov2.make_dinov2("vits", num_register_tokens=4)
    de, head = nets["depth"]["encoder"], nets["depth"]["head"]
    vit = depth.pretrained
    assert (vit.embed_dim, len(vit.blocks), vit.blocks[0].attn.num_heads,
            vit.patch_size, vit.base_grid, vit.num_register_tokens) == (
        de["embed_dim"], de["depth"], de["num_heads"], de["patch_size"],
        de["pos_embed_grid"], de["num_register_tokens"])
    assert vit.blocks[0].mlp.fc1.out_features == de["mlp_ratio"] * 1024
    assert dpt.INTERMEDIATE_LAYER_IDX[encoder] == de["intermediate_layers"]
    assert list(ref.INTERMEDIATE[encoder]) == de["intermediate_layers"]
    assert ref.HEADS[encoder] == de["num_heads"]
    assert depth.depth_head.scratch.layer1_rn.out_channels == head[
        "features"]
    assert [p.out_channels for p in depth.depth_head.projects] == head[
        "out_channels"]
    assert depth.max_depth == head["max_depth"]
    n = sum(p.numel() for p in depth.parameters())
    assert abs(n - nets["depth"]["parameters"]) < 0.05e6
    fe = nets["features"]["encoder"]
    assert (feat.embed_dim, len(feat.blocks), feat.blocks[0].attn.num_heads,
            feat.num_register_tokens) == (fe["embed_dim"], fe["depth"],
                                          fe["num_heads"],
                                          fe["num_register_tokens"])
    assert ref.HEADS[kf_intake.FEATURE_ENCODER] == fe["num_heads"]
    # the tokens: the canonical 616x1064 and the 384x512 frame's 378x504
    ch, cw = priors.Metric3DPredictor.CANONICAL
    assert [ch, cw] == nets["depth"]["input"]["canonical"]
    assert (ch // 14) * (cw // 14) + 1 == nets["depth"]["input"]["tokens"]
    H, W = f["config"]["cam"]["H_out"], f["config"]["cam"]["W_out"]
    assert (H // 14) * (W // 14) + 5 == nets["features"]["input"]["tokens"]


def test_built_networks_match_checkpoints(small, tmp_path):
    cfg = small_config()
    depth, feat, _ = seeded_priors.networks(cfg, 5, "cpu")
    ckpt = tmp_path / "pretrained"
    ckpt.mkdir()
    img = np.random.RandomState(3).rand(64, 128, 3).astype(np.float32)
    with pytest.raises(FileNotFoundError):
        priors.make_prior_fns(cfg, str(tmp_path / "none"), str(ckpt),
                              device="cpu")
    torch.save(depth.state_dict(), ckpt / priors.dpt_checkpoint_name(
        priors.METRIC3D_STAND_IN["metric3d_vit_large"]))
    torch.save(feat.state_dict(), ckpt / "fit3d_dinov2_reg_small_fine.pth")
    from_files = priors.make_prior_fns(cfg, str(tmp_path / "a"), str(ckpt),
                                       device="cpu")
    built = priors.make_prior_fns(cfg, str(tmp_path / "b"), str(ckpt / "x"),
                                  device="cpu",
                                  models={"depth": depth, "feat": feat})
    assert isinstance(built[0].fn, priors.Metric3DPredictor)
    assert not built[0].fn.canonical_trunk
    assert isinstance(built[1].fn, priors.Fit3DFeaturePredictor)
    for a, b in zip(from_files, built):
        out_a, out_b = a(img), b(img)
        np.testing.assert_array_equal(out_a, out_b)
        assert sorted(p.name for p in Path(a.cache_dir).iterdir()) == \
            sorted(p.name for p in Path(b.cache_dir).iterdir()) == [
                "00000.npy"]
    assert built[0](img).shape == (64, 128)
    assert built[1](img).shape == (4, 9, 384)
    # one key alone: the other network comes from its checkpoint
    d, f = priors.make_prior_fns(cfg, str(tmp_path / "c"), str(ckpt),
                                 device="cpu", models={"feat": feat})
    np.testing.assert_array_equal(d(img), from_files[0].fn(img))


def test_keyframe_spans_and_counters(small, tmp_path):
    cfg = small_config()
    depth, feat, _ = seeded_priors.networks(cfg, 6, "cpu")
    depth_fn, feat_fn = priors.make_prior_fns(
        cfg, str(tmp_path), device="cpu",
        models={"depth": depth, "feat": feat})
    img = np.random.RandomState(4).rand(64, 128, 3).astype(np.float32)
    TIMER.reset()
    with TIMER.unit(7.0):
        depth_fn(img)
        feat_fn(img)
    assert {sp.unit for sp in TIMER.records} == {7.0}
    again = priors.CachingPredictor(feat_fn.fn, feat_fn.cache_dir)
    again(img)
    s = TIMER.summary()
    by_id = {sp.id: sp for sp in TIMER.records}

    def parent(name):
        return {by_id[sp.parent].name for sp in TIMER.records
                if sp.name == name}
    assert parent("prior.depth.encoder") == parent("prior.depth.head") == \
        parent("prior.depth.io") == {"prior.depth"}
    assert parent("prior.feat.encoder") == parent("prior.feat.io") == {
        "prior.feat"}
    assert s["prior.depth"]["count"] == s["prior.feat"]["count"] == 1
    assert s["prior.depth.io"]["count"] == 2
    for name in ("prior.depth", "prior.depth.encoder", "prior.depth.head",
                 "prior.feat", "prior.feat.encoder"):
        assert s[name]["device_s"] > 0
    assert s["prior.cache"]["count"] == 3       # two writes, one read
    assert s["prior.cache_hits"] == {"count": 3, "total": 1}
    # (84 / 14) x (140 / 14) + 1 and (64 // 14) x (128 // 14) + 5 tokens
    assert s["prior.tokens"] == {"count": 2, "total": 61 + 41}
    TIMER.reset()


def test_window_ends_when_the_store_is_full(small):
    r = measure(False, 1e6)
    assert r["attempted"] == 8 - 2 and r["failed"] == 0
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "track_ms_per_frame"}
    for c in r["checks"].values():
        assert 0 <= c["value"] < 1e-4


@pytest.fixture(scope="module")
def traced(small):
    return measure(True, 0.0)


@pytest.mark.parametrize("name", METRICS)
def test_prior_metric_reads_a_small_run(traced, name):
    assert traced["correct"], traced["checks"]
    v = traced["metrics"][name]["value"]
    assert math.isfinite(v) and v >= 0
    if name.endswith("_mfu"):
        assert 0 < v <= 100
