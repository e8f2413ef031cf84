"""utils/plot_utils.py without PIL or matplotlib: ``psnr`` equal to the JAX
one; the port's own GIF read back by PIL (frame count, duration, loop;
frames of at most 256 colours exact, others within the median cut's
error); the keyframe figure's panels equal to matplotlib's
``cmap(norm(x), bytes=True)`` and imshow's colour bytes.

The median cut's error, measured on the gradient frames below (3,072
colours each, 48x64): at most 14 of 255 levels in a channel, 3.2-3.5 on
average; the test holds it to 16 and 4.
"""

import os

import matplotlib
import matplotlib.colors
import numpy as np
import pytest
import torch
from PIL import Image

from wildgs_slam_tpu.utils import plot_utils as jpu
from wildgs_slam_tpu_torch.utils import plot_utils as tpu
from wildgs_slam_tpu_torch.utils.png import write_png


def test_psnr_equals_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(48, 64, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(48, 64, 3), 0, 1).astype(np.float32)
    assert tpu.psnr(a, b) == jpu.psnr(a, b)
    assert tpu.psnr(torch.as_tensor(a), torch.as_tensor(b)) == jpu.psnr(a, b)
    assert tpu.psnr(a, a) == jpu.psnr(a, a) == 120.0


def gradient_frame(i, h=48, w=64):
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([(x * 4 + 10 * i) % 256, (y * 5) % 256,
                     ((x + y) * 2 + i) % 256], -1).astype(np.uint8)


def test_gif_read_back_by_pil(tmp_path):
    rng = np.random.RandomState(1)
    frames = [gradient_frame(i) for i in range(3)]
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    frames.append(pal[rng.randint(0, 256, (48, 64))])      # 256 colours
    frames.append(np.zeros((48, 64, 3), np.uint8))         # 1 colour
    frames.append(pal[:3][rng.randint(0, 3, (48, 64))])    # 3 colours
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames):
        write_png(str(d / f"{i:03d}.png"), f)
    out = str(tmp_path / "out.gif")
    assert tpu.create_gif_from_directory(str(d), out, duration=120) == out
    assert tpu.create_gif_from_directory(str(tmp_path / "none"),
                                         out) is None
    im = Image.open(out)
    assert im.n_frames == len(frames)
    assert im.info["duration"] == 120 and im.info["loop"] == 0
    for i, f in enumerate(frames):
        im.seek(i)
        got = np.asarray(im.convert("RGB")).astype(int)
        err = np.abs(got - f.astype(int))
        if len(np.unique(f.reshape(-1, 3), axis=0)) <= 256:
            assert err.max() == 0, i
        else:
            assert err.max() <= 16 and err.mean() <= 4, (i, err.max(),
                                                          err.mean())


def test_lzw_past_a_full_table(tmp_path):
    """A frame long enough to fill the 4,096-code table several times
    (random indices over 256 colours) round-trips exactly."""
    rng = np.random.RandomState(2)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    f = pal[rng.randint(0, 256, (200, 160))]
    path = str(tmp_path / "big.gif")
    with open(path, "wb") as fh:
        fh.write(tpu.encode_gif([f, f[::-1].copy()], duration=40))
    im = Image.open(path)
    for i, ref in enumerate((f, f[::-1])):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), ref)


@pytest.mark.parametrize("with_uncertainty", [False, True])
def test_keyframe_figure_panels_equal_matplotlib(tmp_path, with_uncertainty):
    rng = np.random.RandomState(3)
    gt = rng.rand(48, 64, 3) * 1.2 - 0.1
    ren = rng.rand(48, 64, 3)
    d_gt, d_ren = 1 + rng.rand(48, 64), 2 * rng.rand(48, 64)
    unc = rng.rand(48, 64) if with_uncertainty else None
    panels = tpu.keyframe_panels(gt, ren, d_gt, d_ren, unc, psnr=23.456)

    def cm(name, x):
        norm = matplotlib.colors.Normalize(vmin=x.min(), vmax=x.max())
        return matplotlib.colormaps[name](norm(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(panels[(1, 0)][1], cm("plasma", d_gt))
    np.testing.assert_array_equal(panels[(1, 1)][1], cm("plasma", d_ren))
    for key, img in (((0, 0), gt), ((0, 1), ren)):
        # imshow's bytes of a float RGB image: clipped, x 255, truncated
        np.testing.assert_array_equal(
            panels[key][1], (np.clip(img, 0, 1) * 255).astype(np.uint8))
    assert panels[(0, 1)][0] == "render (PSNR 23.5)"
    if with_uncertainty:
        np.testing.assert_array_equal(panels[(0, 2)][1], cm("jet", unc))

    path = str(tmp_path / "kf" / "fig.png")
    tpu.save_keyframe_figure(path, gt, ren, d_gt, d_ren, unc, psnr=23.456)
    im = Image.open(path)
    n_cols = 3 if with_uncertainty else 2
    assert im.size == (n_cols * 64 + (n_cols - 1) * tpu.GAP,
                       2 * 48 + tpu.GAP)
    assert im.text["title 0,1"] == "render (PSNR 23.5)"
    assert im.text["title 1,1"] == "rendered depth"
    fig = np.asarray(im.convert("RGB"))
    for (r, c), (_, p) in panels.items():
        y, x = r * (48 + tpu.GAP), c * (64 + tpu.GAP)
        np.testing.assert_array_equal(fig[y:y + 48, x:x + 64], p)
    assert os.path.getsize(path) > 0
