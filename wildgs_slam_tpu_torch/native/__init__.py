"""The port's native host library and the frame loader built on it.

``wildgs_native.cpp``, ``png_decode.cpp`` and ``jpeg_decode.cpp`` hold the
port's own PNG and JPEG decoders, the EXIF orientation tag and a binary PLY
writer, in C++ with the standard library alone (no libpng, libjpeg, cv2 or
PIL). The library is built at first use with ``g++`` into ``build/native/``
at the repository root, named by a hash of the sources and flags, and loaded
with ctypes (which releases the GIL during each call). A build that fails
raises with the compiler's message; nothing falls back to another decoder.

- ``decode_png(path)`` / ``decode_jpeg(path)``: (samples, EXIF orientation),
  the samples as stored, like ``utils/png.py::read_png``: uint8 or uint16,
  (H, W) grey or (H, W, 3|4) RGB(A), what ``cv2.imread(path,
  IMREAD_UNCHANGED)`` returns in RGB order;
- ``read_image(path)``: those samples for a .png, .jpg or .jpeg file;
  ``read_color(path)``: what ``cv2.imread(path)`` makes of it, three 8-bit
  channels (RGB order) turned by the file's EXIF orientation;
- ``read_image_native(path, out_w, out_h)``: that colour frame resized as
  the dataset readers resize it, float32 in [0, 1];
- ``FrameLoader``: worker threads that load frames ahead of the caller
  (``Prefetcher`` over any per-index function);
- ``write_ply_native(path, data, names)``: the binary little-endian PLY
  layout of ``slam/gaussian_map.py::save_ply``.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.resample import resize_nearest, resize_u8

SRC = Path(__file__).resolve().parent
SOURCES = ("wildgs_native.cpp", "png_decode.cpp", "jpeg_decode.cpp")
HEADERS = ("native.h",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -ffast-math, no -march=native, no fused multiply-add: results that are
# held equal to numpy's or libjpeg's keep every bit
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-ffp-contract=off"]
_ERR = 512


class _Library:
    """The loaded library (one per process) and how it was built."""

    handle = None
    info: dict = {}


def _compiler() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native library "
                           "(wildgs_slam_tpu_torch/native) is built with g++ "
                           "at first use")
    return path


def build_library() -> dict:
    """Build (unless built) and load the library. Returns {"path",
    "compiler" (first line of g++ --version), "flags", "seconds" (0 when
    the library was already on disk), "bytes"}."""
    if _Library.handle is not None:
        return _Library.info
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((SRC / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libwildgs_native_{tag}.so"
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    seconds = 0.0
    # several processes (pytest workers) may start at once: one builds
    with open(BUILD_DIR / f"{tag}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            out = subprocess.run(
                [cxx, *CXX_FLAGS, *(str(SRC / s) for s in SOURCES), "-o",
                 str(tmp)], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed to build the native "
                                   f"library:\n{out.stderr}")
            os.replace(tmp, lib_path)
            seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    cp, ci, cl, vp = ctypes.c_char_p, ctypes.c_int, ctypes.c_long, \
        ctypes.c_void_p
    ip = ctypes.POINTER(ctypes.c_int)
    for name, argtypes in {
            "wn_peek": [cp, cl, ci, ip, cp, ci],
            "wn_decode": [cp, cl, ci, vp, cl, ip, cp, ci],
            "wn_write_ply": [cp, vp, cl, ci, ctypes.POINTER(cp)]}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    _Library.info = {"path": str(lib_path), "compiler": version,
                     "flags": " ".join(CXX_FLAGS), "seconds": seconds,
                     "bytes": lib_path.stat().st_size}
    _Library.handle = lib
    return _Library.info


def get_lib():
    """The loaded library (built at first use)."""
    if _Library.handle is None:
        build_library()
    return _Library.handle


# ---------------------------------------------------------------- decoding

_FORMATS = {"png": 1, "jpeg": 2}


def decode(data: bytes, name: str = "<bytes>", fmt: str | None = None):
    """PNG or JPEG bytes -> (samples as stored, EXIF orientation 1-8).
    `fmt` "png" or "jpeg" refuses the other format. Corrupt or truncated
    data, and what the decoders do not read, raise ValueError naming
    `name`."""
    lib = get_lib()
    code = _FORMATS[fmt] if fmt else 0
    info = (ctypes.c_int * 5)()
    err = ctypes.create_string_buffer(_ERR)
    if not lib.wn_peek(data, len(data), code, info, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    h, w, ch, nbytes, _ = info
    out = np.empty((h, w, ch), np.uint16 if nbytes == 2 else np.uint8)
    if not lib.wn_decode(data, len(data), code, out.ctypes.data, out.nbytes,
                         info, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return (out[..., 0] if ch == 1 else out), int(info[4])


def _read(path: str, fmt: str):
    with open(path, "rb") as f:
        return decode(f.read(), path, fmt)


def decode_png(path: str):
    """(samples, EXIF orientation) of a PNG file."""
    return _read(path, "png")


def decode_jpeg(path: str):
    """(samples, EXIF orientation) of a JPEG file."""
    return _read(path, "jpeg")


def _decode_by_suffix(path: str):
    suffix = os.path.splitext(path)[1].lower()
    if suffix == ".png":
        return decode_png(path)
    if suffix in (".jpg", ".jpeg"):
        return decode_jpeg(path)
    raise ValueError(f"{path}: not a .png, .jpg or .jpeg file")


def read_image(path: str) -> np.ndarray:
    """An image file's samples as stored (not turned by its EXIF
    orientation, as cv2's IMREAD_UNCHANGED: how depth maps are read)."""
    return _decode_by_suffix(path)[0]


# EXIF orientation -> the view that shows the image upright, as
# cv2.imread applies it (5-8 transpose first)
_ORIENT = {1: lambda a: a, 2: lambda a: a[:, ::-1],
           3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1),
           6: lambda a: a.swapaxes(0, 1)[:, ::-1],
           7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: a.swapaxes(0, 1)[::-1]}


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    return np.ascontiguousarray(_ORIENT[orientation](img))


def color_u8(img: np.ndarray) -> np.ndarray:
    """What cv2.imread(path) (IMREAD_COLOR) makes of decoded samples: three
    8-bit channels (grey repeated, alpha dropped, 16 bits cut to their high
    byte); RGB order."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_color(path: str) -> np.ndarray:
    """cv2.imread(path) in RGB order: 8-bit colour, EXIF orientation
    applied."""
    img, orientation = _decode_by_suffix(path)
    return color_u8(orient(img, orientation))


def read_image_native(path: str, out_w: int, out_h: int) -> np.ndarray:
    """A colour frame resized to (out_h, out_w) as the dataset readers
    resize it (cv2's INTER_LINEAR): float32 RGB in [0, 1]."""
    return resize_u8(read_color(path), (out_h, out_w)).astype(
        np.float32) / 255.0


def read_depth_native(path: str, out_w: int, out_h: int,
                      depth_scale: float) -> np.ndarray:
    """A depth image over `depth_scale`, resized by nearest neighbour."""
    depth = read_image(path).astype(np.float32) / depth_scale
    return resize_nearest(depth, (out_h, out_w))


# ----------------------------------------------------------------- loading

class _Pool:
    """What the workers share: the queue, the finished items, the lock."""

    def __init__(self, load, n, lookahead):
        self.load, self.n = load, n
        self.lookahead = max(1, lookahead)
        self.capacity = 2 * self.lookahead + 4
        self.cv = threading.Condition()
        self.queue = collections.deque()
        self.pending = set()                  # queued or being loaded
        self.done = collections.OrderedDict()  # index -> (ok, item)
        self.closed = False

    def schedule(self, start):
        """Queue the items start ... start + lookahead - 1 (under cv)."""
        for j in range(start, min(start + self.lookahead, self.n)):
            if j not in self.done and j not in self.pending:
                self.pending.add(j)
                self.queue.append(j)
        self.cv.notify_all()

    def work(self, ready):
        # this thread's own intra-op thread count: the worker's torch
        # resamples must not take the cores of the caller's loop
        torch.get_num_threads()
        torch.set_num_threads(1)
        ready.wait()
        while True:
            with self.cv:
                while not self.queue and not self.closed:
                    self.cv.wait()
                if self.closed:
                    return
                i = self.queue.popleft()
            try:
                item = (True, self.load(i))
            except Exception as e:  # noqa: BLE001 - raised again by get(i)
                item = (False, e)
            with self.cv:
                self.pending.discard(i)
                self.done[i] = item
                while len(self.done) > self.capacity:
                    self.done.popitem(last=False)
                self.cv.notify_all()


class Prefetcher:
    """`load(i)` for i in [0, n) on `n_threads` worker threads, up to
    `lookahead` items ahead of the last ``get``; at most ``2 * lookahead +
    4`` finished items are kept. ``get(i)`` in any order returns load(i) (an
    item leaves the cache when it is handed out) or raises what load(i)
    raised. ``close()`` (or the destructor) stops and joins the workers."""

    def __init__(self, load, n: int, n_threads: int = 2, lookahead: int = 4):
        self._pool = _Pool(load, n, lookahead)
        ready = threading.Barrier(max(1, n_threads) + 1)
        caller = torch.get_num_threads()
        self._workers = [threading.Thread(target=self._pool.work,
                                          args=(ready,), daemon=True)
                         for _ in range(max(1, n_threads))]
        for t in self._workers:
            t.start()
        ready.wait()
        # set_num_threads in a worker also changed the count that threads
        # started later take; give them the caller's again
        torch.set_num_threads(caller)

    def __len__(self):
        return self._pool.n

    def get(self, i: int):
        p = self._pool
        if not 0 <= i < p.n:
            raise IndexError(f"item {i} of {p.n}")
        with p.cv:
            p.schedule(i)
            if i in p.queue:          # wanted now: first in line
                p.queue.remove(i)
                p.queue.appendleft(i)
            while i not in p.done:
                if p.closed:
                    raise RuntimeError("the loader is closed")
                if i not in p.pending:   # dropped from the cache meanwhile
                    p.schedule(i)
                p.cv.wait()
            ok, item = p.done.pop(i)
            p.schedule(i + 1)
        if not ok:
            raise item
        return item

    def close(self):
        p = self._pool
        with p.cv:
            p.closed = True
            p.cv.notify_all()
        for t in self._workers:
            t.join()

    def __del__(self):
        if getattr(self, "_workers", None):
            self.close()


class FrameLoader(Prefetcher):
    """Prefetching frame loader over image files: colour frames decoded,
    oriented and resized as the dataset readers do (``read_image_native``),
    or depth frames (``is_depth``) over `depth_scale`, nearest-neighbour
    resized. ``get(i)`` is float32 (out_h, out_w, 3) or (out_h, out_w); a
    frame that fails to decode raises there, naming its file."""

    def __init__(self, paths, out_w: int, out_h: int, n_threads: int = 2,
                 is_depth: bool = False, depth_scale: float = 1.0,
                 lookahead: int = 4):
        paths = list(paths)
        if is_depth:
            frame = functools.partial(read_depth_native, out_w=out_w,
                                      out_h=out_h, depth_scale=depth_scale)
        else:
            frame = functools.partial(read_image_native, out_w=out_w,
                                      out_h=out_h)
        super().__init__(lambda i: frame(paths[i]), len(paths), n_threads,
                         lookahead)


def write_ply_native(path: str, data: np.ndarray, prop_names) -> bool:
    """(n, len(prop_names)) float32 rows -> a binary little-endian PLY with
    one ``property float`` per column. Returns whether it was written."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim != 2 or data.shape[1] != len(prop_names):
        raise ValueError(f"data of shape {data.shape} for {len(prop_names)} "
                         "properties")
    names = (ctypes.c_char_p * len(prop_names))(
        *[n.encode() for n in prop_names])
    return bool(get_lib().wn_write_ply(path.encode(), data.ctypes.data,
                                       data.shape[0], data.shape[1], names))
