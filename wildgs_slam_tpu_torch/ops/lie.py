"""The SE(3)/Sim(3) Lie-group library on torch tensors; the port of
``wildgs_slam_tpu/ops/lie.py``.

Storage layout as there: SE3 elements are 7-vectors ``(tx, ty, tz, qx, qy,
qz, qw)``, Sim3 elements 8-vectors with a trailing scale; twists are
``(tau, phi)`` (``(tau, phi, sigma)`` for Sim3) with translation first, and
the retraction is left multiplication ``exp(xi) * X``. ``SE3`` and ``Sim3``
are thin lietorch-style wrappers over such tensors; ``cat`` concatenates
them.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2, both (..., 4) in (x, y, z, w)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_act(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by unit quaternion q (..., 4)."""
    qv, qw = q[..., :3], q[..., 3:4]
    qv, p = torch.broadcast_tensors(qv, p)
    t = 2.0 * torch.linalg.cross(qv, p, dim=-1)
    return p + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) vector (..., 3) -> unit quaternion (..., 4)."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    half = 0.5 * theta
    small = theta_sq < 1e-8
    s_over = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([phi * s_over, w], dim=-1)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V(phi) (..., 3, 3) such that exp_SE3((tau, phi)).t = V tau."""
    theta_sq = (phi * phi).sum(-1)
    small = theta_sq < 1e-8
    # double-where keeps the untaken branch finite so gradients stay finite
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    a_big = torch.sin(theta) / theta
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / ts_safe)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (1.0 - a_big) / ts_safe)
    Phi = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand_as(Phi)
    return eye + B[..., None, None] * Phi + C[..., None, None] * (Phi @ Phi)


def se3_identity(shape=(), dtype=torch.float32, device="cuda") -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,)).clone()


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) (tau, phi) -> SE3 7-vector."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    t = (so3_left_jacobian(phi) @ tau[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def se3_inv(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:7]
    qinv = quat_conj(q)
    return torch.cat([-quat_act(qinv, t), qinv], dim=-1)


def se3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group composition a ∘ b."""
    ta, qa = a[..., :3], a[..., 3:7]
    tb, qb = b[..., :3], b[..., 3:7]
    return torch.cat([ta + quat_act(qa, tb), quat_mul(qa, qb)], dim=-1)


def se3_act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Act on 3D points p (..., 3)."""
    return quat_act(g[..., 3:7], p) + g[..., :3]


def se3_retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: exp(xi) ∘ g."""
    return se3_mul(se3_exp(xi), g)


# ---------------------------------------------------------------------------
# the tracking half: SO3 log, SE3 log / matrices / adjoints
# ---------------------------------------------------------------------------

def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) (x, y, z, w),
    Shepperd's method with the best-conditioned of four constructions."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(a, b, c, d):
        return torch.stack([b, c, d, a], dim=-1)   # (x, y, z, w) with w = a

    qw = torch.sqrt(torch.clamp(1 + tr, min=_EPS)) / 2
    q0 = mk(qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
            (m10 - m01) / (4 * qw))
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=_EPS)) / 2
    q1 = mk((m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
            (m02 + m20) / (4 * qx))
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=_EPS)) / 2
    q2 = mk((m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
            (m12 + m21) / (4 * qy))
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=_EPS)) / 2
    q3 = mk((m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
            (m12 + m21) / (4 * qz), qz)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> so(3) vector (..., 3)."""
    qv, qw = q[..., :3], q[..., 3:4]
    sgn = torch.where(qw < 0, -1.0, 1.0)     # shortest path (w >= 0)
    qv, qw = qv * sgn, qw * sgn
    nsq = (qv * qv).sum(-1, keepdim=True)
    small = nsq < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq))
    angle = 2.0 * torch.atan2(n, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), angle / n)
    return qv * scale


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """V(phi)^-1 (..., 3, 3)."""
    theta_sq = (phi * phi).sum(-1)
    small = theta_sq < 1e-8
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    half = 0.5 * theta
    # coefficient of [phi]^2: 1/theta^2 - cot(theta/2) / (2 theta)
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        1.0 / ts_safe - torch.cos(half) / (2.0 * theta * torch.sin(half)
                                           + _EPS))
    Phi = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand_as(Phi)
    return eye - 0.5 * Phi + cot_term[..., None, None] * (Phi @ Phi)


def se3_log(g: torch.Tensor) -> torch.Tensor:
    """SE3 7-vector -> se(3) twist (..., 6)."""
    phi = so3_log(g[..., 3:7])
    tau = (so3_left_jacobian_inv(phi) @ g[..., :3, None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def se3_act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Act on homogeneous points (..., 4) = (X, Y, Z, W): rotate xyz and add
    W·t (W is the inverse depth of (X, Y, 1, d) points)."""
    xyz, w = p[..., :3], p[..., 3:4]
    out = quat_act(g[..., 3:7], xyz) + w * g[..., :3]
    return torch.cat([out, w.expand(out.shape[:-1] + (1,))], dim=-1)


def se3_matrix(g: torch.Tensor) -> torch.Tensor:
    """SE3 7-vector -> (..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(g[..., 3:7])
    top = torch.cat([R, g[..., :3, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype,
                          device=g.device).expand(g.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], dim=-1)


def se3_adj_matrix(g: torch.Tensor) -> torch.Tensor:
    """Adjoint (..., 6, 6) = [[R, [t]x R], [0, R]] for the (tau, phi)
    layout."""
    R = quat_to_matrix(g[..., 3:7])
    tR = skew(g[..., :3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_adj(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adj(g) · a for (..., 6) tangent vectors."""
    return (se3_adj_matrix(g) @ a[..., None])[..., 0]


def se3_adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adj(g)^T · a."""
    return (se3_adj_matrix(g).transpose(-1, -2) @ a[..., None])[..., 0]


def se3_normalize(g: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion part."""
    q = g[..., 3:7]
    return torch.cat([g[..., :3], q / torch.linalg.norm(q, dim=-1,
                                                        keepdim=True)], -1)


# ---------------------------------------------------------------------------
# Sim(3) on 8-vectors (tx, ty, tz, qx, qy, qz, qw, s); tangent (tau, phi,
# sigma)
# ---------------------------------------------------------------------------

def sim3_identity(shape=(), dtype=torch.float32, device="cuda"
                  ) -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (8,)).clone()


def sim3_from_se3(g: torch.Tensor, scale=None) -> torch.Tensor:
    s = torch.ones_like(g[..., :1]) if scale is None else scale
    return torch.cat([g, s], dim=-1)


def sim3_inv(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qinv = quat_conj(q)
    sinv = 1.0 / s
    return torch.cat([-sinv * quat_act(qinv, t), qinv, sinv], dim=-1)


def sim3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ta, qa, sa = a[..., :3], a[..., 3:7], a[..., 7:8]
    tb, qb, sb = b[..., :3], b[..., 3:7], b[..., 7:8]
    return torch.cat([ta + sa * quat_act(qa, tb), quat_mul(qa, qb), sa * sb],
                     dim=-1)


def sim3_act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return g[..., 7:8] * quat_act(g[..., 3:7], p) + g[..., :3]


def sim3_act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    xyz, w = p[..., :3], p[..., 3:4]
    out = g[..., 7:8] * quat_act(g[..., 3:7], xyz) + w * g[..., :3]
    return torch.cat([out, w.expand(out.shape[:-1] + (1,))], dim=-1)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent (..., 7) = (tau, phi, sigma) -> Sim3 8-vector:
    t = W(phi, sigma) tau, s = exp(sigma), with the similarity transform's
    left Jacobian W = A I + B Phi + C Phi^2 in four regimes (theta and
    sigma small or not)."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    q = so3_exp_quat(phi)
    s = torch.exp(sigma)
    theta_sq = (phi * phi).sum(-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    Phi = skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(Phi)

    small_s = torch.abs(sigma) < 1e-4
    small_t = theta_sq < 1e-8
    sig_safe = torch.where(small_s, torch.ones_like(sigma), sigma)
    th_safe = torch.where(small_t, torch.ones_like(theta), theta)

    A = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)
    # theta not small (any sigma): the general formulas are sigma-regular
    denom = sigma * sigma + th_safe * th_safe
    sin_t, cos_t = torch.sin(th_safe), torch.cos(th_safe)
    B_full = (s * sin_t * sigma + (1.0 - s * cos_t) * th_safe) / (
        th_safe * denom)
    C_full = (A - ((s * cos_t - 1.0) * sigma + s * sin_t * th_safe)
              / denom) / (th_safe * th_safe)
    # theta small: series in theta, guarded in sigma
    B_small_t = torch.where(small_s, 0.5 + sigma / 3.0,
                            ((sig_safe - 1.0) * s + 1.0) / (sig_safe ** 2))
    C_small_t = torch.where(
        small_s, 1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sig_safe ** 2 - sig_safe + 1.0) - 1.0) / (sig_safe ** 3))
    B = torch.where(small_t, B_small_t, B_full)
    C = torch.where(small_t, C_small_t, C_full)

    W = (A[..., None, None] * eye + B[..., None, None] * Phi
         + C[..., None, None] * (Phi @ Phi))
    t = (W @ tau[..., None])[..., 0]
    return torch.cat([t, q, s[..., None]], dim=-1)


def sim3_log(g: torch.Tensor) -> torch.Tensor:
    """Sim3 8-vector -> sim(3) tangent (..., 7), the inverse of sim3_exp:
    W's columns are sim3_exp's translations of the unit twists, and
    W tau = t is solved."""
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7]
    phi = so3_log(q)
    sigma = torch.log(s)
    eye = torch.eye(3, dtype=g.dtype, device=g.device).expand(
        g.shape[:-1] + (3, 3))
    W = torch.stack([sim3_exp(torch.cat([eye[..., i], phi, sigma[..., None]],
                                        dim=-1))[..., :3]
                     for i in range(3)], dim=-1)
    tau = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma[..., None]], dim=-1)


def sim3_matrix(g: torch.Tensor) -> torch.Tensor:
    R = quat_to_matrix(g[..., 3:7]) * g[..., 7:8, None]
    top = torch.cat([R, g[..., :3, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype,
                          device=g.device).expand(g.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# lietorch-style wrappers
# ---------------------------------------------------------------------------

class SE3:
    """lietorch.SE3-style wrapper over a (..., 7) tensor."""

    manifold_dim = 6
    embedded_dim = 7

    def __init__(self, data):
        self.data = torch.as_tensor(data)

    @property
    def shape(self):
        return self.data.shape[:-1]

    def __getitem__(self, idx):
        return SE3(self.data[idx])

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device="cuda"):
        return cls(se3_identity(shape, dtype, device))

    @classmethod
    def exp(cls, xi):
        return cls(se3_exp(xi))

    @classmethod
    def InitFromVec(cls, data):
        return cls(data)

    def inv(self):
        return SE3(se3_inv(self.data))

    def __mul__(self, other):
        if isinstance(other, SE3):
            return SE3(se3_mul(self.data, other.data))
        other = torch.as_tensor(other, device=self.data.device)
        if other.shape[-1] == 4:
            return se3_act4(self.data, other)
        return se3_act(self.data, other)

    def matrix(self):
        return se3_matrix(self.data)

    def log(self):
        return se3_log(self.data)

    def retr(self, xi):
        return SE3(se3_retr(self.data, xi))

    def adj(self, a):
        return se3_adj(self.data, a)

    def adjT(self, a):
        return se3_adjT(self.data, a)

    def normalize(self):
        return SE3(se3_normalize(self.data))

    def translation(self):
        return self.data[..., :3]

    def quaternion(self):
        return self.data[..., 3:7]


class Sim3:
    """lietorch.Sim3-style wrapper over a (..., 8) tensor."""

    manifold_dim = 7
    embedded_dim = 8

    def __init__(self, data):
        self.data = torch.as_tensor(data)

    @property
    def shape(self):
        return self.data.shape[:-1]

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device="cuda"):
        return cls(sim3_identity(shape, dtype, device))

    def inv(self):
        return Sim3(sim3_inv(self.data))

    def __mul__(self, other):
        if isinstance(other, Sim3):
            return Sim3(sim3_mul(self.data, other.data))
        other = torch.as_tensor(other, device=self.data.device)
        if other.shape[-1] == 4:
            return sim3_act4(self.data, other)
        return sim3_act(self.data, other)

    def matrix(self):
        return sim3_matrix(self.data)


def cat(groups, dim=0):
    """lietorch.cat: one group of the groups' tensors concatenated."""
    return type(groups[0])(torch.cat([g.data for g in groups], dim=dim))
