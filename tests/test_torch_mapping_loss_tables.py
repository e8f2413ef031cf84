"""The mapping loss kernels' per-axis weight tables
(``slam/losses_cuda.py::axis_table``) on the CPU.

M1 (``csrc/mapping_loss.cu``) resamples with per-axis tables read off an
identity basis put through ``ops/ssim.py``'s antialiased resample. Applied
as plain matrix products (rows, then columns) they must give what
``resample_bilinear`` and ``resample_bicubic`` give, within 1e-6 (float32
weights, products summed in float64), at both cells' downsamples to the
DINO grid (384x512 -> 27x36; 360x640 -> 25x45, not an integer ratio) and
the upsample of sigma (27x36 -> 384x512); and the compact table must hold
every nonzero weight of the dense one.
"""

import pytest
import torch

from wildgs_slam_tpu_torch.ops import ssim as ssim_ops
from wildgs_slam_tpu_torch.slam import losses_cuda as lc

RESAMPLE = {"bilinear": ssim_ops.resample_bilinear,
            "bicubic": ssim_ops.resample_bicubic}
CPU = torch.device("cpu")


def dense(table: lc.AxisTable, n_in: int) -> torch.Tensor:
    """The (n_out, n_in) matrix a compact table stands for."""
    n_out = table.start.shape[0]
    out = torch.zeros(n_out, n_in, dtype=torch.float64)
    cols = table.start.long()[:, None] + torch.arange(table.taps)
    return out.scatter_(1, cols, table.weights.double())


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [((384, 512), (27, 36)),
                                     ((360, 640), (25, 45)),
                                     ((27, 36), (384, 512))])
def test_axis_tables_reproduce_the_resamples(src, dst, mode):
    x = torch.rand(src, generator=torch.Generator().manual_seed(0))
    ty, tx = (lc.axis_table(src[k], dst[k], mode, CPU) for k in (0, 1))
    for t, n_in, n_out in ((ty, src[0], dst[0]), (tx, src[1], dst[1])):
        assert t.start.dtype == torch.int32 and t.weights.dtype == torch.float32
        assert int(t.start.min()) >= 0 and int(t.start.max()) + t.taps <= n_in
        assert torch.equal(dense(t, n_in),
                           lc.axis_weights(n_in, n_out, mode, CPU).double())
    got = dense(ty, src[0]) @ x.double() @ dense(tx, src[1]).T
    want = RESAMPLE[mode](x, dst).double()
    assert float((got - want).abs().max()) <= 1e-6
