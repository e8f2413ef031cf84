"""The frozen counts reproduce the bounds of the port's kernel table
(PERF.md) from its shape: T = 768 tiles, K = 512 slots, chunk 64, N =
262,144 rows; 196,864 live slots, 50.4 M live slot-pixels, 12.28% alive,
49,128 distinct rows."""

import torch

from h100_bench import run as hr
from h100_bench.counts import mapping_step, rasterizer as rc

T, K, CK, N = 768, 512, 64, 262144
SLOTS = 196864
SLOT_PIXELS = SLOTS * 256
ALIVE = round(0.1228 * SLOT_PIXELS)
ROWS = 49128


def bound(ops, nbytes):
    return rc.bound_ms(ops, nbytes, hr.load_json(hr.HERE, "peaks.json"))


def test_kernel_table_bounds():
    assert SLOT_PIXELS == 50_397_184
    k1 = bound(rc.k1_ops(SLOT_PIXELS, ALIVE), rc.k1_bytes(SLOTS, T, K // CK))
    k2 = bound(rc.k2_ops(SLOT_PIXELS, ALIVE),
               rc.k2_bytes(SLOTS, T, K, K // CK))
    k3 = bound(0, rc.k3_bytes(ROWS, T, K))
    k4 = bound(0, rc.k4_bytes(SLOTS, T, K, N))
    assert round(k1, 4) == 0.0127
    assert round(k2, 4) == 0.0164
    assert round(k3, 4) == 0.0089
    assert round(k4, 4) == 0.0092
    # K1 and K2 are bound by their operations, K3 and K4 by their bytes
    peaks = hr.load_json(hr.HERE, "peaks.json")
    assert (rc.k1_ops(SLOT_PIXELS, ALIVE) / peaks["fp32_flops"]
            > rc.k1_bytes(SLOTS, T, K // CK) / peaks["hbm_bytes_per_s"])


def test_table_work_counts_pairs():
    """One tile, one chunk of 4 slots: two Gaussians over the tile's
    centre (alive where close), two past the count."""
    table = torch.zeros(1, 4, 16)
    for s, (mx, my, op) in enumerate([(8, 8, 0.9), (100, 100, 0.9)]):
        table[0, s, :10] = torch.tensor([mx, my, 0.5, 0.0, 0.5, 1, 1, 1, op,
                                         1.0])
    counts = torch.tensor([2], dtype=torch.int32)
    tentry = torch.ones(1, 1, 256)
    slots, pairs, alive = rc.table_work(counts, table, tentry, 1, 4)
    assert (slots, pairs) == (2, 512)
    # the near Gaussian: pixels where 0.9 exp(-r^2 / 4) >= 1/255; the far
    # one reaches none of them
    yy, xx = torch.meshgrid(torch.arange(16) + 0.0, torch.arange(16) + 0.0,
                            indexing="ij")
    r2 = (xx - 8) ** 2 + (yy - 8) ** 2
    assert alive == int((0.9 * torch.exp(-0.25 * r2) >= 1 / 255).sum())


def test_step_ops_grows_with_the_work():
    base = mapping_step.step_ops(100_000, 10 ** 9, 2 * 10 ** 9, (384, 512),
                                 (27, 36), 303, False)
    assert base > 3 * 10 ** 9
    assert mapping_step.step_ops(100_000, 10 ** 9, 2 * 10 ** 9, (384, 512),
                                 (27, 36), 303, True) < base
