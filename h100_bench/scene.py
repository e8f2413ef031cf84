"""The benchmark's one traffic generator: a textured box room seen by a
camera that orbits inside it.

Every frame is made on the device from (seed, frame index) alone, so the
same seed gives the same frames, the program and the reference are handed
the same tensors, and a frame can be made again after the window. The room,
its texture and the trajectory are the same for every seed; the seed draws
the image noise and the DINO features, so every seed asks for the same
work. The geometry follows ``chip_smoke.py::room_scene`` (the room's half
extents, its texture), with a closed orbit in place of its straight
walk, so that any number of keyframes stays inside the room.

Parameters come from a traffic file (``traffic/<mix>.json``):

- ``yaw_per_frame``: the camera's turn between two consecutive frames (rad);
  its centre moves along a circle of ``orbit_radius`` m at the same angle;
- ``noise``: the standard deviation of the per-pixel image noise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

HALF = (3.0, 2.0, 5.0)     # the room's half extents (m), as room_scene's
PATCH = 14                 # DINOv2's patch: features on an (H/14, W/14) grid
FEATURE_DIM = 384


class Frame(NamedTuple):
    image: torch.Tensor   # (H, W, 3) float32 in [0, 1]
    depth: torch.Tensor   # (H, W) float32 metric depth (the exact prior)
    w2c: torch.Tensor     # (7,) world -> camera, (tx, ty, tz, qx, qy, qz, qw)
    dino: torch.Tensor    # (H // 14, W // 14, 384) float32 N(0, 1)


def camera(cfg: dict):
    """((H, W), (fx, fy, cx, cy)) of the configuration's output camera, as
    the dataset readers resize and crop: the input is scaled to
    (W_out + 2 W_edge, H_out + 2 H_edge) and the edges cut off."""
    cam = cfg["cam"]
    H, W = cam["H_out"], cam["W_out"]
    sx = (W + 2 * cam["W_edge"]) / cam["W"]
    sy = (H + 2 * cam["H_edge"]) / cam["H"]
    return (H, W), (cam["fx"] * sx, cam["fy"] * sy,
                    cam["cx"] * sx - cam["W_edge"],
                    cam["cy"] * sy - cam["H_edge"])


def _matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3) -> unit quaternion (x, y, z, w), through the
    largest of the four squared components (Shepperd's method: no division
    by a component near zero, also at half turns)."""
    t = float(R[0, 0] + R[1, 1] + R[2, 2])
    d = [float(R[0, 0]), float(R[1, 1]), float(R[2, 2])]
    if t >= max(d):
        w = 0.5 * (1.0 + t) ** 0.5
        q = [(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w), w]
    else:
        i = d.index(max(d))
        j, k = (i + 1) % 3, (i + 2) % 3
        v = [0.0, 0.0, 0.0]
        v[i] = 0.5 * (1.0 + d[i] - d[j] - d[k]) ** 0.5
        v[j] = (R[j, i] + R[i, j]) / (4 * v[i])
        v[k] = (R[k, i] + R[i, k]) / (4 * v[i])
        q = v + [(R[k, j] - R[j, k]) / (4 * v[i])]
    q = torch.tensor([float(x) for x in q], dtype=R.dtype)
    return q / torch.linalg.norm(q)


def pose(i: int, traffic: dict, dtype=torch.float64):
    """(R_c2w (3, 3), centre (3,)) of frame i, in float64 on the CPU."""
    a = traffic["yaw_per_frame"] * i
    r = traffic["orbit_radius"]
    centre = torch.tensor([r * math.sin(a), 0.15 * math.sin(2 * a),
                           r * (math.cos(a) - 1.0)], dtype=dtype)
    yaw, pitch = a + 0.2 * math.sin(0.5 * a), 0.1 * math.sin(a)
    cy_, sy_ = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    Ry = torch.tensor([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], dtype=dtype)
    Rx = torch.tensor([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=dtype)
    return Ry @ Rx, centre


def w2c_of(i: int, traffic: dict) -> torch.Tensor:
    """(7,) float32 world -> camera pose of frame i (CPU)."""
    R, o = pose(i, traffic)
    Rw = R.T
    return torch.cat([-Rw @ o, _matrix_to_quat(Rw)]).to(torch.float32)


def frame_generator(seed: int, i: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(i) + 1) % (2 ** 63))
    return g


def make_frame(cfg: dict, traffic: dict, seed: int, i: int,
               device) -> Frame:
    """Frame i of the stream of `seed`, made on `device`."""
    (H, W), (fx, fy, cx, cy) = camera(cfg)
    R, o = pose(i, traffic)
    R = R.to(torch.float32).to(device)
    o = o.to(torch.float32).to(device)
    yy, xx = torch.meshgrid(torch.arange(H, device=device) + 0.5,
                            torch.arange(W, device=device) + 0.5,
                            indexing="ij")
    rays = torch.stack([(xx - cx) / fx, (yy - cy) / fy,
                        torch.ones_like(xx)], -1)
    d = rays @ R.T
    half = torch.tensor(HALF, device=device)
    safe = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    tw = torch.where(d > 0, (half - o) / safe, (-half - o) / safe)
    tw = torch.where(torch.isfinite(tw) & (tw > 0), tw,
                     torch.full_like(tw, float("inf")))
    t = tw.amin(-1)
    p = o + t[..., None] * d
    depth = t * rays[..., 2]
    img = torch.stack([
        0.5 + 0.35 * torch.sin(3.1 * p[..., 0] + 1.7 * p[..., 1]),
        0.5 + 0.35 * torch.cos(2.3 * p[..., 2] - 1.1 * p[..., 0]),
        0.5 + 0.25 * torch.sin(4.0 * p[..., 1] + 0.7 * p[..., 2])
        * torch.cos(1.3 * p[..., 0])], -1)
    g = frame_generator(seed, i, device)
    img = img + traffic["noise"] * torch.randn(img.shape, generator=g,
                                               device=device)
    feats = torch.randn((H // PATCH, W // PATCH, FEATURE_DIM), generator=g,
                        device=device)
    return Frame(torch.clamp(img, 0.0, 1.0), depth.to(torch.float32),
                 w2c_of(i, traffic).to(device), feats)
