"""fp32 operations the tracker's mathematics needs, frozen here: the
numerator of ``track.mfu``.

Convolutions count 2 operations per multiply-add of their direct form (C_in
x k x k per output element), whatever algorithm cuDNN picks (the FFT
convolutions the update operator gets count as the direct ones). Per frame
the motion filter encodes it with fnet and runs one update-operator step
against the last keyframe (its one-edge correlation volume included); a
keyframe is also encoded with cnet. Per graph iteration: the update
operator on every active edge, its aggregation per source frame, the
correlation lookup, and the BA's normal equations (the per-edge Jacobian
products, the Schur products of every source frame with the window's
poses, the Cholesky solve) for each of its Gauss-Newton iterations. Every
new edge builds its all-pairs correlation volume. Elementwise activations
and norms are left out: they are a fraction of a percent beside the
convolutions.
"""

from __future__ import annotations

LEVEL_SLOTS = 4 * 49          # correlation samples per pixel
LOOKUP_PER_SAMPLE = 8         # bilinear: 4 products and 3 sums, + 1


def conv(c_in, c_out, k, h, w):
    return 2 * c_in * c_out * k * k * h * w


def encoder(H, W, out_dim):
    """BasicEncoder at the input size (H, W): stride 2, 2, 2."""
    h1, w1, h2, w2, h3, w3 = H // 2, W // 2, H // 4, W // 4, H // 8, W // 8
    return (conv(3, 32, 7, h1, w1) + 4 * conv(32, 32, 3, h1, w1)
            + conv(32, 64, 3, h2, w2) + 3 * conv(64, 64, 3, h2, w2)
            + conv(32, 64, 1, h2, w2)
            + conv(64, 128, 3, h3, w3) + 3 * conv(128, 128, 3, h3, w3)
            + conv(64, 128, 1, h3, w3) + conv(128, out_dim, 1, h3, w3))


def update_per_edge(h, w):
    return (conv(196, 128, 1, h, w) + conv(128, 128, 3, h, w)
            + conv(4, 128, 7, h, w) + conv(128, 64, 3, h, w)
            + 3 * conv(448, 128, 3, h, w) + 4 * conv(128, 128, 1, h, w)
            + 2 * (conv(128, 128, 3, h, w) + conv(128, 2, 3, h, w))
            + conv(128, 128, 3, h, w)
            + h * w * LEVEL_SLOTS * LOOKUP_PER_SAMPLE)


def update_per_frame(h, w):
    """GraphAgg's per-source-frame convolutions and heads."""
    return (conv(128, 128, 3, h, w) + conv(128, 1, 3, h, w)
            + conv(128, 576, 1, h, w))


def corr_volume(h, w, c=128):
    return 2 * (h * w) ** 2 * c


def ba_iteration(edges, frames, poses, h, w):
    """Per edge and pixel: the 2x6 Jacobians' four Hessian blocks and two
    gradients, the depth couplings; per source frame the Schur products
    (6 poses x 6 poses x pixels); the Cholesky solve."""
    hw = h * w
    per_edge = hw * (4 * 2 * 6 * 6 * 2 + 2 * 2 * 6 * 2 + 2 * 2 * 6 * 2 + 16)
    schur = frames * (6 * poses) ** 2 * hw * 2 + frames * 6 * poses * hw * 4
    return edges * per_edge + schur + (6 * poses) ** 3 // 3


def stretch_ops(hw, frames, keyframes, edge_log, new_edges):
    """Operations of a profiled stretch: `frames` motion-filter steps,
    `keyframes` context encodes, the graph iterations of `edge_log` [(active
    edges, all edges, pose window, BA iterations, source frames)] and
    `new_edges` correlation volumes."""
    H, W = hw
    h, w = H // 8, W // 8
    ops = frames * (encoder(H, W, 128) + update_per_edge(h, w)
                    + update_per_frame(h, w) + corr_volume(h, w))
    ops += keyframes * encoder(H, W, 256)
    for active, total, poses, ba_iters, sources in edge_log:
        ops += active * update_per_edge(h, w) + sources * update_per_frame(
            h, w)
        ops += ba_iters * ba_iteration(total, sources, poses, h, w)
    return ops + new_edges * corr_volume(h, w)
