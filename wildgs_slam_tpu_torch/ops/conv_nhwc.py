"""The update operator's convolutions: the CUDA kernel ``conv_nhwc``
(``csrc/conv_nhwc.cu``), its plain version, and the weights it takes.

An NHWC, stride-1, "same"-padded float32 convolution as one implicit GEMM,
with its inputs and epilogue fused:

- up to four sources, read where they lie and concatenated along channels
  in the K loop (the GRU's ``net | inp | corr | flow`` features are never
  concatenated in memory); a source may be a channel slice of a larger
  tensor (pixels evenly strided, channels contiguous);
- ``scale``: a multiplier of source 0, channel by channel (the GRU's
  ``r * net``);
- epilogue ``v = act(conv + bias + glo[e])`` with ``glo`` a per-image
  per-channel vector (the GRU's ``conv*_glo(glo)`` term) and ``act`` one of
  none, relu, sigmoid, tanh; then ``mul``: ``v * mul``, or ``blend = (h,
  z)``: ``(1 - z) * h + z * v`` (the GRU's new state).

Weights are re-laid once to ``(k, k, C_in, N)`` (``pack``: several
convolutions that read the same input concatenated along N, so they run as
one launch) and kept per module until a parameter changes (``packs``).

``conv_nhwc_plain`` computes the same function with ``F.conv2d`` (under
``float32_convs``) and the same epilogue arithmetic. The wrapper takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
It counts its launches in ``conv_nhwc.launches``. The tile is chosen from
the shapes and the card's SMs (``plan``); no tile changes a result.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import ptr as _ptr, stream as _stream
from ..utils.precision import float32_convs

MAX_SOURCES = 4
ACTS = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
MODE_PLAIN, MODE_MUL, MODE_BLEND = 0, 1, 2
TILES = ((128, 128), (128, 64), (128, 16), (32, 128), (32, 64))  # (BM, BN)
NARROW, SHORT = 2, 3       # the heads' tile; SHORT + i: tile i, 32 rows high
_NULL = ctypes.c_void_p(None)
_ACT_FNS = {"none": lambda v: v, "relu": F.relu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}


class Packed(NamedTuple):
    """Convolution weights as the kernel reads them."""

    w: torch.Tensor       # (k, k, C_in, N rounded up to 4), zeros past N
    bias: torch.Tensor    # (N,)
    n: int
    k: int


@torch.no_grad()
def pack(*convs) -> Packed:
    """nn.Conv2d modules of one input and one kernel size, their outputs
    concatenated in order."""
    w = torch.cat([c.weight.detach() for c in convs], 0)    # (N, C, k, k)
    n, k = w.shape[0], w.shape[-1]
    wt = w.permute(2, 3, 1, 0)
    if n % 4:
        wt = F.pad(wt, (0, 4 - n % 4))
    bias = torch.cat([c.bias.detach() for c in convs])
    return Packed(wt.contiguous(), bias.contiguous(), n, k)


def packs(owner, groups) -> dict:
    """{name: Packed} of `groups` ({name: tuple of nn.Conv2d}), packed once
    and kept on `owner` until one of their parameters is replaced, moved or
    written in place."""
    params = [p for convs in groups.values() for c in convs
              for p in (c.weight, c.bias)]
    key = tuple((id(p), p.data_ptr(), p._version) for p in params)
    cached = owner.__dict__.get("_conv_packs")
    if cached is None or cached[0] != key:
        cached = (key, {name: pack(*convs) for name, convs in groups.items()})
        owner.__dict__["_conv_packs"] = cached
    return cached[1]


def plan(m: int, n: int, sms: int) -> int:
    """The tile for M output pixels and N channels on a card of `sms` SMs:
    by N (128 wide above 64 channels, 64 wide above 16, else the narrow
    one), 128 rows high, or 32 where 128 rows would give fewer blocks than
    the card has SMs (one edge: M = 3,072)."""
    tile = NARROW if n <= 16 else 1 if n <= 64 else 0
    bm, bn = TILES[tile]
    if tile != NARROW and -(-m // bm) * -(-n // bn) < sms:
        tile += SHORT
    return tile


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _pixel_stride(name, x, shape, dev, aligned):
    """Check an NHWC operand of `shape` on `dev`, channels contiguous and
    pixels evenly strided; return the pixel stride in floats."""
    if x.device != dev or x.dtype != torch.float32 or x.shape != shape:
        raise ValueError(f"conv_nhwc: {name} is {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}, expected float32 {tuple(shape)} "
                         f"on {dev}")
    e, h, w, c = shape
    st = x.stride()
    s = st[2]
    if (st[3] != 1 or s < c or (h > 1 and st[1] != w * s)
            or (e > 1 and st[0] != h * w * s)):
        raise ValueError(f"conv_nhwc: {name} must be NHWC with contiguous "
                         f"channels and evenly strided pixels, got strides "
                         f"{st}")
    if aligned and (s % 4 or c % 4 or x.data_ptr() % 16):
        raise ValueError(f"conv_nhwc: {name} needs channels and pixel stride "
                         f"in multiples of 4 and 16-byte alignment")
    return s


def _check(srcs, packed, glo, scale, mul, blend):
    """Validate the operands of one call; returns their pixel strides."""
    if not 1 <= len(srcs) <= MAX_SOURCES:
        raise ValueError(f"conv_nhwc: 1 to {MAX_SOURCES} sources, got "
                         f"{len(srcs)}")
    x0 = srcs[0]
    dev = x0.device
    if x0.dim() != 4 or min(x.shape[-1] for x in srcs) < 1:
        raise ValueError(f"conv_nhwc: sources are (E, H, W, C >= 1), got "
                         f"{[tuple(x.shape) for x in srcs]}")
    e, h, w, _ = x0.shape
    strides = [_pixel_stride(f"source {i}", x, (e, h, w, x.shape[-1]), dev,
                             True) for i, x in enumerate(srcs)]
    c_in = sum(x.shape[-1] for x in srcs)
    k, n = packed.k, packed.n
    for name, t, shape in (("w", packed.w, (k, k, c_in, -(-n // 4) * 4)),
                           ("bias", packed.bias, (n,))):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"conv_nhwc: {name} must be a contiguous float32 "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if k % 2 == 0:
        raise ValueError(f"conv_nhwc: odd kernel sizes only, got {k}")
    out = {"src": strides}
    if scale is not None:
        out["scale"] = _pixel_stride("scale", scale, x0.shape, dev, True)
    if glo is not None:
        if (glo.device != dev or glo.dtype != torch.float32
                or glo.shape != (e, n) or glo.stride(1) != 1):
            raise ValueError(f"conv_nhwc: glo must be float32 ({e}, {n}) on "
                             f"{dev} with contiguous channels")
        out["glo"] = glo.stride(0)
    if mul is not None and blend is not None:
        raise ValueError("conv_nhwc: mul or blend, not both")
    out_shape = (e, h, w, n)
    if mul is not None:
        out["aux"] = _pixel_stride("mul", mul, out_shape, dev, False)
    if blend is not None:
        out["aux"] = _pixel_stride("blend h", blend[0], out_shape, dev, False)
        out["gate"] = _pixel_stride("blend z", blend[1], out_shape, dev,
                                    False)
    widest = max(strides + [n] + [out[a] for a in ("scale", "aux", "gate")
                                  if a in out])
    if e * h * w * widest >= 2 ** 31:       # the kernel's 32-bit offsets
        raise ValueError("conv_nhwc: 2**31 elements or more")
    return out


def conv_nhwc_plain(srcs, packed: Packed, act: str = "none", *, glo=None,
                    scale=None, mul=None, blend=None):
    """F.conv2d on the concatenated sources, then the same epilogue."""
    srcs = [srcs] if isinstance(srcs, torch.Tensor) else list(srcs)
    if scale is not None:
        srcs[0] = srcs[0] * scale
    x = torch.cat(srcs, dim=-1) if len(srcs) > 1 else srcs[0]
    weight = packed.w[..., :packed.n].permute(3, 2, 0, 1)
    with float32_convs():
        v = F.conv2d(x.permute(0, 3, 1, 2), weight, packed.bias,
                     padding=packed.k // 2).permute(0, 2, 3, 1)
    if glo is not None:
        v = v + glo[:, None, None, :]
    v = _ACT_FNS[act](v)
    if mul is not None:
        v = v * mul
    if blend is not None:
        h, z = blend
        v = (1 - z) * h + z * v
    return v.contiguous()


def conv_nhwc(srcs, packed: Packed, act: str = "none", *, glo=None,
              scale=None, mul=None, blend=None):
    """srcs: an NHWC tensor (E, H, W, C) or a sequence of up to four (their
    channels concatenated, C_in in all); packed: Packed (k, k, C_in, N);
    act: "none", "relu", "sigmoid" or "tanh"; glo (E, N) added before the
    activation; scale (E, H, W, C_0) multiplies source 0; mul (E, H, W, N)
    multiplies the activated output, or blend = (h, z), both (E, H, W, N),
    gives (1 - z) * h + z * output. -> (E, H, W, N) float32, contiguous."""
    srcs = [srcs] if isinstance(srcs, torch.Tensor) else list(srcs)
    if act not in ACTS:
        raise ValueError(f"conv_nhwc: unknown activation {act!r}")
    strides = _check(srcs, packed, glo, scale, mul, blend)
    dev = srcs[0].device
    if dev.type == "cpu":
        return conv_nhwc_plain(srcs, packed, act, glo=glo, scale=scale,
                               mul=mul, blend=blend)
    if dev.type != "cuda":
        raise ValueError(f"conv_nhwc: unsupported device {dev}")
    e, h, w = srcs[0].shape[:3]
    n, k = packed.n, packed.k
    out = torch.empty(e, h, w, n, device=dev)
    xs = [_ptr(x) for x in srcs] + [_NULL] * (MAX_SOURCES - len(srcs))
    cs = [x.shape[-1] for x in srcs] + [0] * (MAX_SOURCES - len(srcs))
    ss = strides["src"] + [0] * (MAX_SOURCES - len(srcs))
    if mul is not None:
        mode, aux, gate = MODE_MUL, mul, None
    elif blend is not None:
        mode, (aux, gate) = MODE_BLEND, blend
    else:
        mode, aux, gate = MODE_PLAIN, None, None
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.conv_nhwc(
            *xs, _ptr_or_null(scale), _ptr(packed.w), _ptr(packed.bias),
            _ptr_or_null(glo), _ptr_or_null(aux), _ptr_or_null(gate),
            _ptr(out), *cs, *ss, strides.get("scale", 0),
            strides.get("glo", 0), strides.get("aux", 0),
            strides.get("gate", 0), e, h, w, n, packed.w.shape[-1],
            k, ACTS[act], mode, plan(e * h * w, n, _sms(dev)),
            _stream(dev))
    if err:
        raise RuntimeError(f"conv_nhwc launch failed: CUDA error {err}")
    conv_nhwc.launches += 1
    return out


def _ptr_or_null(x):
    return _NULL if x is None else _ptr(x)


conv_nhwc.launches = 0
