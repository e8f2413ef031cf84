"""Operations and bytes the rasterizer's four kernels need, frozen here.

The counting is that of the port's kernel table (PERF.md): K1 and K2 need
15 fp32 operations for every live slot-pixel pair of a chunk that a tile
opens (the geometry that finds a pair dead or alive: dx, dy, the power,
exp counted as one, the raw alpha and the two tests), and for every alive
pair (alpha >= 1/255 and transmittance after it >= 1e-4) 15 more in K1
(blending and the four sums) or 55 more in K2 (g, the suffix, dalpha, the
10 gradients and their sums). K3 and K4 move bytes: each distinct input
row, id and output once. A chunk is open when its first slot lies below
the tile's count and some pixel's transmittance entering it is >= 1e-4.
"""

from __future__ import annotations

import torch

F4 = 4                     # bytes per float32 or int32
ATTR_F = 16                # lanes of a table row
PIXELS = 256               # a 16x16 tile
OPS_PER_LIVE_PAIR = 15
FWD_OPS_PER_ALIVE_PAIR = 15
BWD_OPS_PER_ALIVE_PAIR = 55
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ONE_M_MIN = 0.01           # 1 - alpha >= 1 - 0.99


def k1_ops(slot_pixels: int, alive: int) -> int:
    return OPS_PER_LIVE_PAIR * slot_pixels + FWD_OPS_PER_ALIVE_PAIR * alive


def k2_ops(slot_pixels: int, alive: int) -> int:
    return OPS_PER_LIVE_PAIR * slot_pixels + BWD_OPS_PER_ALIVE_PAIR * alive


def k1_bytes(slots: int, tiles: int, n_chunks: int) -> int:
    """Live rows read; counts and tile ids; colour, depth, alpha and the
    final transmittance written; the transmittance entering each chunk."""
    return (slots * ATTR_F * F4 + tiles * 2 * F4
            + tiles * PIXELS * 6 * F4 + tiles * n_chunks * PIXELS * F4)


def k2_bytes(slots: int, tiles: int, capacity: int, n_chunks: int) -> int:
    """Live rows, counts and tile ids, the chunks' entering transmittance
    and five cotangent planes read; every slot's gradient row written."""
    return (slots * ATTR_F * F4 + tiles * 2 * F4
            + tiles * n_chunks * PIXELS * F4 + tiles * PIXELS * 5 * F4
            + tiles * capacity * ATTR_F * F4)


def k3_bytes(distinct_rows: int, tiles: int, capacity: int) -> int:
    """Each distinct row and every id read, the whole table written."""
    return (distinct_rows * ATTR_F * F4 + tiles * capacity * F4
            + tiles * capacity * ATTR_F * F4)


def k4_bytes(live_slots: int, tiles: int, capacity: int, n_rows: int) -> int:
    """The live slots' cotangent rows and every id read, every row of the
    (n_rows, 16) result written once."""
    return (live_slots * ATTR_F * F4 + tiles * capacity * F4
            + n_rows * ATTR_F * F4)


def bound_ms(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: operations at the fp32 peak or
    bytes at the memory peak, whichever is longer."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"]
               ) * 1e3


@torch.no_grad()
def table_work(counts, table, tentry, tw: int, ck: int):
    """(slots, slot_pixels, alive) of one K1/K2 launch: counts (T,) int,
    table (T, K, 16), tentry (T, K // ck, 256) the transmittance entering
    each chunk (K1's output), tw tiles per image row."""
    T, K, _ = table.shape
    n_chunks = K // ck
    dev = table.device
    starts = torch.arange(n_chunks, device=dev) * ck
    opened = (starts[None] < counts[:, None].long()) & (
        tentry.amax(-1) >= T_EPS)
    live = torch.clamp(counts[:, None].long() - starts[None], 0, ck)
    slots = int((live * opened).sum())
    lin = torch.arange(PIXELS, device=dev)
    tiles = torch.arange(T, device=dev)
    px = ((tiles % tw)[:, None] * 16 + lin % 16).to(torch.float32)
    py = ((tiles // tw)[:, None] * 16 + lin // 16).to(torch.float32)
    alive = 0
    for c in range(n_chunks):
        blk = table[:, c * ck:(c + 1) * ck]
        slot = c * ck + torch.arange(ck, device=dev)
        slot_live = slot[None, :] < counts[:, None].long()
        dx = blk[..., 0:1] - px[:, None, :]
        dy = blk[..., 1:2] - py[:, None, :]
        power = (-0.5 * (blk[..., 2:3] * dx * dx + blk[..., 4:5] * dy * dy)
                 - blk[..., 3:4] * dx * dy)
        a = torch.clamp(blk[..., 8:9] * torch.exp(power), max=0.99)
        dead = (power > 0) | (a < ALPHA_MIN) | ~slot_live[..., None]
        a = torch.where(dead, torch.zeros_like(a), a)
        t_after = tentry[:, c][:, None, :] * torch.cumprod(
            torch.clamp(1.0 - a, min=ONE_M_MIN), dim=1)
        alive += int((~dead & (t_after >= T_EPS)
                      & opened[:, c, None, None]).sum())
    return slots, slots * PIXELS, alive
