"""Splat-SLAM mono-depth fill for the mapping branch without metric depth;
the port's own copy of ``wildgs_slam_tpu/slam/depth_fill.py``.

1. A keyframe with fewer than 100 multiview-valid frontend depths is
   invalid, and the mapper skips it.
2. The mono prior is cleaned (values above 4x its mean zeroed), its
   support eroded 5 times behind a border of ones, and the holes filled by
   harmonic diffusion from their boundary.
3. The cleaned mono depth is aligned to the frontend depth by the weighted
   scale/shift least squares over the eroded and valid pixels
   (``utils/common.align_scale_and_shift``), or by the scale alone where
   that 2x2 system is singular.
4. The frontend depth's invalid pixels take the aligned mono depth.

Every step runs as torch on the depth's device and computes what the JAX
package computes where neither scipy nor cv2 is installed: the erosion is
its numpy branch (equal to scipy's) and the hole fill its harmonic branch,
not ``cv2.inpaint(..., INPAINT_NS)``, which the JAX package takes where cv2
is installed. The fill reads the device a few times: the valid count, the
conditioning guard and the diffusion's stop test, 8 steps per read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.common import align_scale_and_shift

INPAINT_STEPS = 512     # the harmonic fill's step limit
INPAINT_TOL = 1e-5      # stop once max |step| over the hole is below this
STEPS_PER_READ = 8      # diffusion steps between two reads of the stop test


def binary_erosion_padded(binary: torch.Tensor, iterations: int = 5
                          ) -> torch.Tensor:
    """3x3 binary erosion repeated `iterations` times on the mask padded by
    `iterations` ones (the pad keeps the erosion off the image borders);
    outside the padded mask counts as False."""
    b = F.pad(binary.to(torch.float32)[None, None], (iterations,) * 4,
              value=1.0)
    for _ in range(iterations):
        b = -F.max_pool2d(-F.pad(b, (1, 1, 1, 1), value=0.0), 3, stride=1)
    return b[0, 0, iterations:-iterations, iterations:-iterations] > 0.5


def _diffuse(out: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """One Jacobi step of the 4-neighbour average on the hole (edges
    replicated; numpy's sum order)."""
    p = F.pad(out[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    avg = 0.25 * (((p[:-2, 1:-1] + p[2:, 1:-1]) + p[1:-1, :-2])
                  + p[1:-1, 2:])
    return torch.where(hole, avg, out)


def inpaint_ns(depth: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """Fill `hole` pixels by harmonic diffusion: the hole starts at the
    known pixels' mean, then Jacobi steps of the 4-neighbour average until
    the largest change on the hole falls below 1e-5 (at most 512 steps).
    The JAX package's fallback where cv2 is not installed."""
    depth = depth.to(torch.float32)
    if not bool(hole.any()):
        return depth
    known = ~hole
    n_known = int(known.sum())
    if n_known == 0:
        return depth.clone()
    mean = (torch.where(known, depth, 0.0).to(torch.float64).sum()
            / n_known).to(torch.float32)
    out = torch.where(hole, mean, depth)
    for _ in range(0, INPAINT_STEPS, STEPS_PER_READ):
        outs = [out]
        for _ in range(STEPS_PER_READ):
            outs.append(_diffuse(outs[-1], hole))
        # each step's largest change (0 off the hole); the first step that
        # converged, else the last: exact as one read per step would be
        steps = torch.stack(outs)
        done = ((steps[1:] - steps[:-1]).abs().amax((1, 2))
                < INPAINT_TOL).tolist()
        if True in done:
            return outs[1 + done.index(True)]
        out = outs[-1]
    return out


def splat_slam_fill(est_depth: torch.Tensor, valid_mask: torch.Tensor,
                    mono_depth: torch.Tensor, min_valid: int = 100):
    """est_depth (H, W) frontend (BA) depth at full resolution, valid_mask
    (H, W) bool multiview consistency, mono_depth (H, W) mono-prior depth
    (0 where there is none). Returns (depth, invalid, scale, shift); an
    invalid keyframe carries the masked frontend depth only."""
    valid = valid_mask.to(torch.bool)
    est = torch.where(valid, est_depth.to(torch.float32), 0.0)
    if int(valid.sum()) < min_valid:
        return est, True, 1.0, 0.0

    mono = mono_depth.to(torch.float32)
    mono = torch.where(mono > 4.0 * mono.mean(), 0.0, mono)
    eroded = binary_erosion_padded(mono > 0, iterations=5)
    mono = torch.where(eroded, mono, 0.0)
    mono = inpaint_ns(mono, mono == 0.0)

    w = (eroded & valid).to(torch.float32)
    # conditioning guard (the reference divides by a determinant that a
    # near-constant prior makes ~0): the scale-only least squares there;
    # in Python floats, as the JAX package decides it
    a00, a01, a11, b0 = torch.stack([
        (w * mono * mono).sum(), (w * mono).sum(), w.sum(),
        (w * mono * est).sum()]).tolist()
    det = a00 * a11 - a01 * a01
    if det > 1e-6 * max(a00 * a11, 1e-12):
        scale, shift, _ = align_scale_and_shift(mono, est, w)
        scale, shift = torch.stack([scale, shift]).tolist()
    else:
        scale, shift = b0 / max(a00, 1e-12), 0.0
    est = torch.where(valid, est, mono * scale + shift)
    return est, False, scale, shift
