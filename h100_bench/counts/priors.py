"""fp32 operations the keyframe priors' networks need, frozen here: the
numerators of ``prior.encoder_mfu`` and ``prior.head_mfu``.

2 operations per multiply-add. The vision transformer: the patch
embedding, and per block the qkv, output and MLP GEMMs (24 N d^2 at an MLP
ratio of 4) and the attention's two products (4 N^2 d over all heads);
softmax, norms and activations are left out (a fraction of a percent).
The DPT head: every convolution in its direct form (C_in x k x k per
output element, a transposed convolution at stride = kernel one tap per
output), whatever algorithm cuDNN picks; the bilinear resizes and the
residual adds are left out.
"""

from __future__ import annotations

PATCH = 14


def vit(tokens: int, patches: int, dim: int, depth: int,
        mlp_ratio: float = 4.0) -> int:
    """One forward of `depth` blocks over `tokens` tokens, `patches` of them
    embedded from 14x14x3 pixels."""
    hidden = int(dim * mlp_ratio)
    gemms = 2 * tokens * dim * (3 * dim + dim + 2 * hidden)
    attention = 4 * tokens * tokens * dim
    return 2 * patches * 3 * PATCH * PATCH * dim + depth * (gemms + attention)


def conv(c_in, c_out, k, h, w):
    return 2 * c_in * c_out * k * k * h * w


def dpt_head(ph: int, pw: int, in_dim: int, features: int,
             out_channels) -> int:
    """The head at a (ph, pw) patch grid (``reference/priors.py::dpt_head``
    names the layers)."""
    c = list(out_channels)
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw),
             ((ph + 1) // 2, (pw + 1) // 2)]
    ops = sum(conv(in_dim, ci, 1, ph, pw) for ci in c)
    ops += conv(c[0], c[0], 1, *sizes[0])          # transposed, stride 4
    ops += conv(c[1], c[1], 1, *sizes[1])          # transposed, stride 2
    ops += conv(c[3], c[3], 3, *sizes[3])          # stride 2
    ops += sum(conv(ci, features, 3, *s) for ci, s in zip(c, sizes))
    rcu = 2 * conv(features, features, 3, 1, 1)    # per pixel

    def fusion(at, units, out):
        return units * rcu * at[0] * at[1] + conv(features, features, 1, *out)
    ops += fusion(sizes[3], 1, sizes[2])
    ops += fusion(sizes[2], 2, sizes[1])
    ops += fusion(sizes[1], 2, sizes[0])
    up = (2 * sizes[0][0], 2 * sizes[0][1])
    ops += fusion(sizes[0], 2, up)
    ops += conv(features, features // 2, 3, *up)
    full = (ph * PATCH, pw * PATCH)
    return ops + conv(features // 2, 32, 3, *full) + conv(32, 1, 1, *full)


def depth_call(ph: int, pw: int, dim: int, depth: int, features: int,
               out_channels, n_prefix: int = 1) -> dict:
    """{"encoder", "head"} operations of one DepthAnythingV2 call."""
    return {"encoder": vit(ph * pw + n_prefix, ph * pw, dim, depth),
            "head": dpt_head(ph, pw, dim, features, out_channels)}
