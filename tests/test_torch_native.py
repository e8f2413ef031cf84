"""The port's native library (``wildgs_slam_tpu_torch/native``) against cv2,
the numpy PNG decoder, the JAX package's readers and native library.

Tolerances, and why:
- PNG: bit-equal to ``cv2.imread(path, IMREAD_UNCHANGED)`` (RGB order) on
  every colour type, bit depth and interlace cv2 (libpng) reads, and after
  ``color_u8`` to ``cv2.imread(path)``; bit-equal to ``utils/png.py`` where
  that one reads;
- JPEG: bit-equal to ``cv2.imread(path)`` (libjpeg-turbo: the ISLOW IDCT,
  fancy upsampling and the fixed-point colour tables are reproduced); no
  mode needs a tolerance;
- EXIF orientation 1-8: the colour frame equal to the JAX reader's
  ``cv2.imread`` before the resize, within one level after it (the
  readers' tolerance, tests/test_torch_datasets.py);
- ``FrameLoader`` / ``PrefetchingStream``: bit-equal to the reader;
  against the JAX ``FrameLoader``, whose own float bilinear differs from
  cv2's, the mean difference under 0.02 (its own test's bound,
  tests/test_native.py);
- PLY: byte-equal.
"""

import json
import os
import struct
import threading
import zlib

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_datasets import FILTERS, cfgs, png_kinds, texture
from wildgs_slam_tpu import native as jnative
from wildgs_slam_tpu.utils import datasets as jds
from wildgs_slam_tpu_torch import native
from wildgs_slam_tpu_torch.slam import gaussian_map as tgm
from wildgs_slam_tpu_torch.utils import datasets as tds
from wildgs_slam_tpu_torch.utils.png import decode_png as numpy_decode_png
from wildgs_slam_tpu_torch.utils.png import read_png

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_jpeg")


def cv2_unchanged(path):
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[..., [2, 1, 0] + ([3] if ref.shape[2] == 4 else [])]
    return ref


def assert_like_cv2(path):
    out, orientation = native.decode_png(path) if path.endswith(".png") \
        else native.decode_jpeg(path)
    ref = cv2_unchanged(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape, path
    np.testing.assert_array_equal(out, ref, err_msg=path)
    np.testing.assert_array_equal(native.color_u8(out),
                                  cv2.imread(path)[..., ::-1], err_msg=path)
    return out


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png_raw(samples, ctype, depth, interlace=0, palette=None,
                   trns=None, extra=b""):
    """Any colour type and bit depth, Adam7 or not, filter None: the chunk
    layout and zlib written by hand (cv2 writes neither palettes nor
    interlace)."""
    h, w = samples.shape[:2]
    s = samples.reshape(h, w, -1).astype(np.int64)

    def rows(block):
        bh, bw, ch = block.shape
        if not bh or not bw:
            return b""
        flat = block.reshape(bh, bw * ch)
        if depth == 16:
            b = flat.astype(">u2").view(np.uint8).reshape(bh, -1)
        elif depth == 8:
            b = flat.astype(np.uint8)
        else:
            per = 8 // depth
            pad = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per)))
            pad = pad.reshape(bh, -1, per)
            b = sum(pad[..., k] << (8 - depth * (k + 1))
                    for k in range(per)).astype(np.uint8)
        return np.concatenate([np.zeros((bh, 1), np.uint8), b], 1).tobytes()
    body = (b"".join(rows(s[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7)
            if interlace else rows(s))
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    return (out + extra + png_chunk(b"IDAT", zlib.compress(body))
            + png_chunk(b"IEND", b""))


# (colour type, bit depth, tRNS): every combination PNG allows
PNG_KINDS = ([(0, d, False) for d in (1, 2, 4, 8, 16)]
             + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]
             + [(c, d, t) for c in (2,) for d in (8, 16) for t in (False, True)]
             + [(c, d, False) for c in (4, 6) for d in (8, 16)]
             + [(0, 8, True)])


def png_kind_file(tmp_path, ctype, depth, trns, interlace, h=37, w=29):
    rng = np.random.RandomState(depth * 10 + ctype)
    extra = {}
    if ctype == 3:
        n = min(200, 2 ** depth)
        samples = rng.randint(0, n, (h, w))
        extra["palette"] = rng.randint(0, 256, (n, 3))
        if trns:
            extra["trns"] = bytes(rng.randint(0, 256, n // 2 + 1)
                                  .astype(np.uint8))
    else:
        ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        samples = rng.randint(0, 2 ** depth, (h, w, ch))
        if trns and ctype == 2:
            samples[:6, :6] = [5, 6, 7]          # the transparent colour
            extra["trns"] = struct.pack(">HHH", 5, 6, 7)
        elif trns:
            extra["trns"] = struct.pack(">H", 5)   # cv2 ignores it
    path = str(tmp_path / f"c{ctype}_{depth}_{int(trns)}_{interlace}.png")
    with open(path, "wb") as f:
        f.write(encode_png_raw(samples, ctype, depth, interlace, **extra))
    return path


@pytest.mark.parametrize("ctype,depth,trns", PNG_KINDS)
def test_png_kinds_equal_cv2(tmp_path, ctype, depth, trns):
    for interlace in (0, 1):
        out = assert_like_cv2(png_kind_file(tmp_path, ctype, depth, trns,
                                            interlace))
        if ctype in (0, 2, 6) and depth >= 8 and not trns and not interlace:
            path = png_kind_file(tmp_path, ctype, depth, trns, 0)
            np.testing.assert_array_equal(read_png(path), out)


@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_png_filters_equal_cv2_and_numpy_decoder(tmp_path, filt):
    for kind, img in png_kinds(h=40, w=56).items():
        path = str(tmp_path / f"{kind}.png")
        bgr = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
        assert cv2.imwrite(path, bgr, FILTERS[filt])
        out = assert_like_cv2(path)
        np.testing.assert_array_equal(read_png(path), out, err_msg=kind)


def test_png_480x640_with_every_row_filter(tmp_path):
    """One full-width frame, as phase 8 of chip_smoke.py writes them: the
    numpy writer's five filters in turn, native against numpy and cv2."""
    from wildgs_slam_tpu_torch.utils.png import encode_png

    img = texture(480, 640, 4).astype(np.uint8)
    data = encode_png(img, (0, 1, 2, 3, 4))
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(data)
    out = assert_like_cv2(path)
    np.testing.assert_array_equal(out, numpy_decode_png(data))
    np.testing.assert_array_equal(out, img)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
JPEG_MODES = ([f"baseline_{s}" for s in SAMPLING]
              + [f"progressive_{s}" for s in SAMPLING]
              + ["grey", "progressive_grey", "restart", "optimized"])


def jpeg_params(mode, quality):
    p = [cv2.IMWRITE_JPEG_QUALITY, quality]
    kind, _, s = mode.partition("_")
    if kind == "progressive":
        p += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if s in SAMPLING:
        p += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[s]]
    if mode == "restart":
        p += [cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]
    if mode == "optimized":
        p += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    return p


@pytest.mark.parametrize("mode", JPEG_MODES)
def test_jpeg_modes_equal_cv2(tmp_path, mode):
    """Every size class: whole MCUs, odd sizes cut inside an MCU, one
    block; three qualities."""
    for h, w in ((48, 64), (37, 29), (61, 80), (8, 8)):
        img = texture(h, w, h + w).astype(np.uint8)
        if "grey" in mode:
            img = img[..., 0]
        for q in (50, 90, 100):
            path = str(tmp_path / f"{h}x{w}_{q}.jpg")
            assert cv2.imwrite(path, img, jpeg_params(mode, q))
            out = assert_like_cv2(path)
            assert out.shape == img.shape


def test_jpeg_480x640_equals_cv2(tmp_path):
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, texture(480, 640, 5).astype(np.uint8),
                jpeg_params("baseline_420", 95))
    assert_like_cv2(path)


def sof_edit(data, offset, value):
    """The JPEG with one byte of its SOF0 segment (offset from the marker)
    replaced."""
    i = data.index(b"\xff\xc0")
    return data[:i + offset] + bytes([value]) + data[i + offset + 1:]


@pytest.mark.parametrize("case,pattern", [
    ("arithmetic", "arithmetic"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("12-bit", "12-bit"),
    ("4 components", "4 components")])
def test_unsupported_jpeg_modes_raise(tmp_path, case, pattern):
    data = cv2.imencode(".jpg", texture(16, 16, 0).astype(np.uint8))[1] \
        .tobytes()
    edit = {"arithmetic": (1, 0xC9), "lossless": (1, 0xC3),
            "hierarchical": (1, 0xC5), "12-bit": (4, 12),
            "4 components": (9, 4)}[case]
    path = str(tmp_path / "odd.jpg")
    with open(path, "wb") as f:
        f.write(sof_edit(data, *edit))
    with pytest.raises(ValueError, match=f"odd.jpg.*{pattern}"):
        native.decode_jpeg(path)


def test_read_image_refuses_other_formats(tmp_path):
    path = str(tmp_path / "frame.bmp")
    cv2.imwrite(path, texture(8, 8, 0).astype(np.uint8))
    with pytest.raises(ValueError, match="frame.bmp"):
        tds.read_image(path)
    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, texture(8, 8, 0).astype(np.uint8))
    with pytest.raises(ValueError, match="frame.png.*not a JPEG"):
        native.decode_jpeg(png)


FUZZ = 200


@pytest.mark.parametrize("fmt", ["png", "jpeg", "progressive_jpeg"])
def test_fuzzed_files_raise(fmt):
    """200 seeded truncations and bit flips each. PNG: every one raises
    ValueError naming the file (every chunk's CRC and the Adler-32 are
    checked). JPEG: every truncation raises (no EOI, or entropy-coded data
    that ends early); a flipped bit inside entropy-coded data can decode
    to another valid image, so a flip raises ValueError or gives an array
    of the frame's declared size; never a crash."""
    img = texture(40, 56, 9).astype(np.uint8)
    data = (cv2.imencode(".png", img)[1] if fmt == "png" else
            cv2.imencode(".jpg", img, jpeg_params(
                "progressive_420" if fmt.startswith("progressive")
                else "restart", 90))[1]).tobytes()
    native.decode(data, "clean")
    rng = np.random.RandomState(11)
    decoded = 0
    for t in range(FUZZ):
        a = bytearray(data)
        truncated = t % 2 == 0
        if truncated:
            a = a[:rng.randint(0, len(a))]
        else:
            for _ in range(rng.randint(1, 4)):
                i = rng.randint(len(a))
                a[i] ^= 1 << rng.randint(8)
        try:
            out, _ = native.decode(bytes(a), f"fuzz{t}")
        except ValueError as e:
            assert f"fuzz{t}" in str(e)
            continue
        assert fmt != "png" and not truncated, f"case {t} decoded"
        assert out.ndim in (2, 3) and out.dtype == np.uint8
        decoded += 1
    assert decoded < FUZZ // 2      # some flips are caught as corrupt


def test_build_failure_raises_the_compiler_message(monkeypatch):
    """No fallback: a library that does not build raises with g++'s
    message."""
    monkeypatch.setattr(native._Library, "handle", None)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["-fno-such-flag-for-this-test"])
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.get_lib()


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------

def exif_block(orientation, little_endian):
    e = "<" if little_endian else ">"
    return ((b"II*\x00" if little_endian else b"MM\x00*")
            + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))


def write_oriented(path, rgb, orientation, little_endian):
    tiff = exif_block(orientation, little_endian)
    if path.endswith(".png"):
        data = encode_png_raw(rgb, 2, 8, extra=png_chunk(b"eXIf", tiff))
    else:
        jpg = cv2.imencode(".jpg", rgb[..., ::-1],
                           jpeg_params("baseline_420", 95))[1].tobytes()
        app1 = b"Exif\0\0" + tiff
        data = (jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
                + app1 + jpg[2:])
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("suffix", [".png", ".jpg"])
@pytest.mark.parametrize("little_endian", [True, False])
def test_exif_orientation_against_jax_reader(tmp_path, suffix,
                                             little_endian):
    """Orientations 1-8: the port's colour frame equals cv2.imread (what
    the JAX reader reads) before the resize, and the JAX reader's frame
    within one level after it; depth is read as stored."""
    rgb = texture(48, 64, 2).astype(np.uint8)
    for o in range(1, 9):
        root = tmp_path / f"o{o}"
        os.makedirs(root)
        path = str(root / f"0000{suffix}")
        write_oriented(path, rgb, o, little_endian)
        turned = native.read_color(path)
        np.testing.assert_array_equal(turned, cv2.imread(path)[..., ::-1],
                                      err_msg=f"orientation {o}")
        assert turned.shape == ((48, 64, 3) if o <= 4 else (64, 48, 3))
        np.testing.assert_array_equal(native.read_image(path),
                                      cv2_unchanged(path))
        jcfg, tcfg = cfgs("rgb_nopose", str(root))
        jc = jds.get_dataset(jcfg)[0][1]
        tc = tds.get_dataset(tcfg)[0][1]
        assert np.abs(tc - jc).max() <= 1.0 / 255 + 1e-7, o


# ---------------------------------------------------------------------------
# committed fixtures (the ones chip_smoke.py decodes on the card)
# ---------------------------------------------------------------------------

def load_fixtures():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def fixture_decode(entry):
    ref = read_png(os.path.join(FIXTURES, entry["decode"]))
    return ref.reshape(entry["shape"]).astype(entry["dtype"])


def test_committed_fixtures_still_equal_cv2():
    """Each fixture's committed decode (a PNG from utils/png.py::write_png)
    is still cv2's, and the native decoders give it."""
    entries = load_fixtures()
    assert len(entries) >= 12
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 200 * 1024
    for e in entries:
        path = os.path.join(FIXTURES, e["file"])
        ref = fixture_decode(e)
        if e["mode"] == "color":
            np.testing.assert_array_equal(ref, cv2.imread(path)[..., ::-1])
            np.testing.assert_array_equal(native.read_color(path), ref)
        else:
            np.testing.assert_array_equal(ref, cv2_unchanged(path))
            np.testing.assert_array_equal(native.read_image(path), ref)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def test_ply_bytes_equal_jax_native_writer_and_save_ply(tmp_path):
    from tests.test_torch_system import small_map

    p = small_map(300, seed=5)
    p["f_rest"] = np.random.RandomState(6).normal(size=(300, 3, 3)).astype(
        np.float32)
    m = tgm.create(300, max_sh_degree=1, device="cpu")
    for k, v in p.items():
        getattr(m.params, k).copy_(torch.from_numpy(v))
    m.aux.alive.fill_(True)
    n = tgm.save_ply(m, str(tmp_path / "map.ply"))
    assert n == 300
    with open(tmp_path / "map.ply", "rb") as f:
        saved = f.read()
    header, _, body = saved.partition(b"end_header\n")
    names = [ln.split()[-1].decode() for ln in header.splitlines()
             if ln.startswith(b"property float")]
    data = np.frombuffer(body, "<f4").reshape(n, len(names))
    assert native.write_ply_native(str(tmp_path / "port.ply"), data, names)
    assert jnative.write_ply_native(str(tmp_path / "jax.ply"), data, names)
    for name in ("port.ply", "jax.ply"):
        with open(tmp_path / name, "rb") as f:
            assert f.read() == saved, name


# ---------------------------------------------------------------------------
# the frame loader and the prefetching stream
# ---------------------------------------------------------------------------

def write_frames(root, n, h=48, w=64, jpeg_every=2):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        img = texture(h, w, 30 + i).astype(np.uint8)
        path = os.path.join(root, f"{i:04d}" + (
            ".jpg" if i % jpeg_every == 0 else ".png"))
        cv2.imwrite(path, img)
        paths.append(path)
    return paths


def test_frame_loader_equals_reader_out_of_order(tmp_path):
    """Lookahead 2 keeps at most 8 frames: 14 frames read forwards, then
    back and forth across the evictions, each bit-equal to a fresh
    decode; depth frames too."""
    paths = write_frames(str(tmp_path / "rgb"), 14)
    depths = []
    for i in range(14):
        p = str(tmp_path / f"d{i}.png")
        cv2.imwrite(p, (np.random.RandomState(i).rand(48, 64) * 20000)
                    .astype(np.uint16))
        depths.append(p)
    fl = native.FrameLoader(paths, 40, 32, n_threads=3, lookahead=2)
    dl = native.FrameLoader(depths, 40, 32, n_threads=1, is_depth=True,
                            depth_scale=5000.0, lookahead=2)
    assert fl._pool.capacity == 8
    for i in list(range(14)) + [0, 13, 5, 5, 2, 11, 7, 1]:
        c = fl.get(i)
        assert c.dtype == np.float32 and c.shape == (32, 40, 3)
        np.testing.assert_array_equal(
            c, native.read_image_native(paths[i], 40, 32))
        np.testing.assert_array_equal(
            dl.get(i), native.read_depth_native(depths[i], 40, 32, 5000.0))
    fl.close()
    dl.close()


def test_frame_loader_within_the_jax_loader(tmp_path):
    """The JAX loader resizes with its own float bilinear (not cv2's), so
    only its own test's bound holds: mean |diff| < 0.02 (un-rotated
    files)."""
    paths = write_frames(str(tmp_path / "rgb"), 5, jpeg_every=1 << 30)
    ours = native.FrameLoader(paths, 40, 32)
    theirs = jnative.FrameLoader(paths, 40, 32)
    for i in (0, 3, 1, 4, 2):
        assert float(np.abs(ours.get(i) - theirs.get(i)).mean()) < 0.02
    ours.close()


def test_frame_loader_raises_naming_the_file_and_joins(tmp_path):
    paths = write_frames(str(tmp_path / "rgb"), 4)
    with open(paths[2], "wb") as f:
        f.write(b"\xff\xd8\xff\xdb")     # a JPEG cut short
    parent = torch.get_num_threads()
    fl = native.FrameLoader(paths, 40, 32, n_threads=2, lookahead=4)
    assert torch.get_num_threads() == parent
    fl.get(0)
    fl.get(1)
    with pytest.raises(ValueError, match=os.path.basename(paths[2])):
        fl.get(2)
    fl.get(3)
    workers = fl._workers
    fl.close()
    assert not any(t.is_alive() for t in workers)
    with pytest.raises(RuntimeError):
        fl.get(0)


def test_prefetcher_under_contention():
    """More workers than items in flight and a short switch interval: every
    item arrives exactly once per get, in any order, none lost."""
    import sys

    calls = []
    lock = threading.Lock()

    def load(i):
        with lock:
            calls.append(i)
        return np.full(3, i)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pf = native.Prefetcher(load, 50, n_threads=8, lookahead=3)
        order = list(range(50)) + list(range(49, -1, -7))
        for i in order:
            np.testing.assert_array_equal(pf.get(i), np.full(3, i))
        pf.close()
    finally:
        sys.setswitchinterval(old)
    assert set(calls) == set(range(50))


def test_prefetching_stream_equals_dataset(tmp_path):
    """A TUM sequence with undistortion (the port undistorts in its reader)
    and JPEG colour frames: stream[i] == ds[i] bit for bit, out of order,
    across the cache's eviction; len and attributes pass through."""
    from tests.test_torch_datasets import write_tum

    root = str(tmp_path / "seq")
    write_tum(root, n=10)
    for i, line in enumerate(open(os.path.join(root, "rgb.txt"))
                             .read().splitlines()[3:]):
        if i % 2:
            continue
        name = line.split()[1]
        img = cv2.imread(os.path.join(root, name))
        os.remove(os.path.join(root, name))
        cv2.imwrite(os.path.join(root, name[:-4] + ".jpg"), img)
    with open(os.path.join(root, "rgb.txt")) as f:
        text = f.read()
    lines = text.splitlines()
    for i in range(3, len(lines), 2):
        lines[i] = lines[i].replace(".png", ".jpg")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(lines))
    _, tcfg = cfgs("tumrgbd", root,
                   distortion=[0.2312, -0.7849, -0.0033, -0.0001, 0.9172])
    ds = tds.get_dataset(tcfg)
    ps = tds.PrefetchingStream(ds, n_threads=2, lookahead=2)
    assert len(ps) == len(ds) == 10 and ps.intrinsic is ds.intrinsic
    assert ps.distortion is not None and ps.poses is ds.poses
    for i in list(range(10)) + [9, 0, 4, 4, 8, 1]:
        a, b = ps[i], ds[i]
        assert a[0] == b[0] == i
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    ps.close()
