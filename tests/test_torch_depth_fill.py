"""The Splat-SLAM depth fill (``slam/depth_fill.py``): the port against the
JAX package on the same numpy inputs.

The JAX functions take scipy's erosion and ``cv2.inpaint`` where those are
installed; the card's machine has neither, so the JAX package computes
there its numpy erosion and its harmonic fill, and so does the port
everywhere. The tests hide cv2 (and, in one erosion case, scipy.ndimage)
from the JAX functions so that they run those branches.

Tolerances, and why:
- erosion: equal, against both JAX branches (booleans);
- the harmonic fill: atol 1e-5 (the same float32 steps in numpy's sum
  order; only the hole's starting mean is summed in another order);
- ``splat_slam_fill``: scale and shift within 4e-4 of the JAX package's and
  2e-4 of the truth where the prior is an exact affine map of it, filled
  depths within 5e-5. The 2x2 normal equations cancel heavily (their
  determinant is a difference of products of sums over thousands of
  pixels), so float32 sums in another order move the solution: measured
  on 48x64 frames, scale and shift up to 9.3e-5 from a float64 solve of
  the same system in both packages (the port's sums 1.2e-5 on the affine
  case, the JAX package's 3.5e-5), up to 3.1e-4 apart (the shift of the
  prior with a hole); the filled depths only 1.9e-5 apart, because the two
  errors cancel over the prior's range;
- against ``cv2.INPAINT_NS``: the difference is measured, not hidden
  (ROADMAP Queue 3). On a 6x8 hole in a ramp of 2.0-2.9 m the harmonic
  fill is 1.1e-4 from the truth at most (a linear ramp is harmonic), cv2's
  0.037; the two differ by 0.037 at most, 0.013 on average. The test
  holds them to 1e-3 and 0.05 from the truth and a difference of 0.01-0.05.
"""

import sys

import numpy as np
import pytest
import torch

from wildgs_slam_tpu.slam import depth_fill as jfill
from wildgs_slam_tpu_torch.slam import depth_fill as tfill

torch.set_num_threads(1)


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def ramp(H=32, W=40):
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (2.0 + 0.01 * xx + 0.02 * yy).astype(np.float32)


def masks():
    rng = np.random.RandomState(0)
    yield rng.rand(24, 30) > 0.25
    yield np.ones((20, 20), bool)
    m = np.ones((48, 64), bool)
    m[10:30, 5:20] = False
    m[0, :] = False
    yield m
    yield rng.rand(33, 17) > 0.05


@pytest.mark.parametrize("branch", ["scipy", "numpy"])
def test_erosion_equals_both_jax_branches(branch, monkeypatch):
    if branch == "numpy":
        monkeypatch.setitem(sys.modules, "scipy.ndimage", None)
    for m in masks():
        want = jfill.binary_erosion_padded(m, iterations=5)
        got = tfill.binary_erosion_padded(torch.from_numpy(m), iterations=5)
        np.testing.assert_array_equal(got.numpy(), want)


def inpaint_cases():
    rng = np.random.RandomState(1)
    d = ramp()
    hole = np.zeros_like(d, bool)
    hole[10:16, 12:20] = True
    yield np.where(hole, 0.0, d).astype(np.float32), hole   # converges
    d = (1.0 + rng.rand(40, 48)).astype(np.float32)
    hole = rng.rand(40, 48) < 0.3
    yield np.where(hole, 0.0, d).astype(np.float32), hole
    d = ramp(48, 64)
    hole = np.zeros_like(d, bool)
    hole[4:44, 6:58] = True          # too wide to converge in 512 steps
    yield np.where(hole, 0.0, d).astype(np.float32), hole
    yield d, np.zeros_like(d, bool)   # nothing to fill


def test_inpaint_follows_jax_harmonic_fill(no_cv2):
    for depth, hole in inpaint_cases():
        want = jfill.inpaint_ns(depth, hole)
        got = tfill.inpaint_ns(torch.from_numpy(depth), torch.from_numpy(hole))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_array_equal(got.numpy()[~hole], depth[~hole])


def fill_cases():
    """(est, valid, mono) of tests/test_depth_fill.py, plus a near-constant
    prior (the scale-only branch) and a hole cut into the prior."""
    H, W = 48, 64
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    true = (2.0 + 0.01 * xx + 0.005 * yy).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[20:30, 20:40] = False
    yield "affine", true, valid, (true - 0.3) / 0.5
    est = (2.0 + 0.01 * xx[:40, :50]).astype(np.float32)
    v = np.ones((40, 50), bool)
    v[5:12, 5:12] = False
    mono = est.copy()
    mono[0, 0] = 1e6
    yield "outlier", est, v, mono
    v = np.zeros((30, 40), bool)
    v[0, :25] = True
    yield "invalid", np.full((30, 40), 3.0, np.float32), v, np.ones(
        (30, 40), np.float32)
    yield "constant", true, valid, np.full((H, W), 1.5, np.float32)
    mono = (true + 1.0) / 2.0
    mono[8:20, 30:50] = 0.0
    yield "prior hole", true, valid, mono.astype(np.float32)


def test_splat_slam_fill_follows_jax(no_cv2):
    branches = {}
    for name, est, valid, mono in fill_cases():
        jd, jinv, js, jq = jfill.splat_slam_fill(est, valid, mono)
        td, tinv, ts, tq = tfill.splat_slam_fill(
            torch.from_numpy(est), torch.from_numpy(valid),
            torch.from_numpy(np.asarray(mono, np.float32)))
        assert tinv == jinv, name
        np.testing.assert_allclose(td.numpy(), jd, atol=5e-5, err_msg=name)
        np.testing.assert_allclose([ts, tq], [js, jq], atol=4e-4,
                                   err_msg=name)
        branches[name] = (tinv, tq == 0.0, ts, tq)
    assert branches["invalid"][:2] == (True, True)
    assert branches["constant"][:2] == (False, True)     # scale only
    # exact affine priors are recovered
    np.testing.assert_allclose(branches["affine"][2:], [0.5, 0.3], atol=2e-4)
    np.testing.assert_allclose(branches["prior hole"][2:], [2.0, -1.0],
                               atol=2e-4)


def test_harmonic_fill_against_cv2_inpaint_ns():
    """What the port (and the JAX package without cv2) computes, against
    what the JAX package computes with cv2: measured on a smooth ramp."""
    cv2 = pytest.importorskip("cv2")
    d = ramp()
    hole = np.zeros_like(d, bool)
    hole[10:16, 12:20] = True
    broken = np.where(hole, 0.0, d).astype(np.float32)
    ns = cv2.inpaint(broken, hole.astype(np.uint8), inpaintRadius=3,
                     flags=cv2.INPAINT_NS)
    np.testing.assert_array_equal(ns, jfill.inpaint_ns(broken, hole))
    harm = tfill.inpaint_ns(torch.from_numpy(broken),
                            torch.from_numpy(hole)).numpy()
    err_ns = np.abs(ns - d)[hole].max()
    err_harm = np.abs(harm - d)[hole].max()
    diff = np.abs(ns - harm)[hole]
    print(f"hole max |fill - truth|: INPAINT_NS {err_ns:.5f}, harmonic "
          f"{err_harm:.5f}; |harmonic - INPAINT_NS| max {diff.max():.5f} "
          f"mean {diff.mean():.5f}")
    assert err_harm < 1e-3 and err_ns < 0.05
    assert 0.01 < diff.max() < 0.05
