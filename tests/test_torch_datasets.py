"""The port's dataset readers against the JAX package's (which read with
cv2), on tiny folders written here from a numpy seed.

Tolerances, and why:
- the PNG decoder: bit-equal to ``cv2.imread(path, IMREAD_UNCHANGED)`` (RGB
  order) on PNGs cv2 writes, with each of its row-filter settings;
- colour frames: within one uint8 level (1/255) of the JAX reader: cv2
  resizes uint8 images in 11-bit fixed point, the port in float32 and
  rounds (on a 480x640 textured frame about one value in eight differs by
  that level);
- depth frames: equal (nearest-neighbour sampling at cv2's indices);
- poses and intrinsics: equal;
- undistortion (cv2's map rounded to 1/32 pixel, bilinear remap, then the
  resize): within two uint8 levels of the JAX reader's cv2.undistort +
  cv2.resize, the remap's and the resize's rounding each one level at most
  (the remap alone differs by one level on about 0.5% of the values).
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from wildgs_slam_tpu.config import load_config
from wildgs_slam_tpu.utils import datasets as jds
from wildgs_slam_tpu_torch.config import load_config as tload_config
from wildgs_slam_tpu_torch.utils import datasets as tds
from wildgs_slam_tpu_torch.utils.png import read_png

FILTERS = {"default": [], "all": [cv2.IMWRITE_PNG_FILTER,
                                  cv2.IMWRITE_PNG_ALL_FILTERS],
           "avg": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_AVG],
           "paeth": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_PAETH]}


def texture(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0),
                    128 + 90 * np.cos(yy / 5.0 + seed),
                    (xx * yy + 17 * seed) % 256], -1)
    return np.clip(img + rng.randint(0, 24, img.shape), 0, 255)


def png_kinds(seed=0, h=96, w=128):
    img = texture(h, w, seed).astype(np.uint8)
    return {"rgb": img, "rgba": np.concatenate([img, img[..., 1:2]], -1),
            "gray": img[..., 0],
            "depth16": (img[..., 0].astype(np.uint16) * 211
                        + np.random.RandomState(seed).randint(0, 97, (h, w))
                        ).astype(np.uint16)}


def cv2_rgb(path):
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[..., [2, 1, 0] + ([3] if ref.shape[2] == 4 else [])]
    return ref


@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_png_decoder_equals_cv2(tmp_path, filt):
    for kind, img in png_kinds().items():
        path = str(tmp_path / f"{kind}.png")
        bgr = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
        assert cv2.imwrite(path, bgr, FILTERS[filt])
        out = read_png(path)
        ref = cv2_rgb(path)
        assert out.dtype == ref.dtype and out.shape == ref.shape, kind
        np.testing.assert_array_equal(out, ref, err_msg=f"{kind} {filt}")


def test_png_decoder_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "palette.png")
    Image.fromarray(png_kinds()["gray"]).convert("P").save(path)
    with pytest.raises(ValueError, match="palette.png"):
        read_png(path)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

H, W = 48, 64     # the images on disk


def write_tum(root, n=4, pose_file="groundtruth.txt"):
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rng = np.random.RandomState(7)
    lines = {"rgb.txt": [], "depth.txt": [], pose_file: []}
    for i in range(n):
        t = 1000.0 + 0.1 * i
        cv2.imwrite(os.path.join(root, "rgb", f"{t:.6f}.png"),
                    texture(H, W, i).astype(np.uint8), FILTERS["all"])
        cv2.imwrite(os.path.join(root, "depth", f"{t + 0.01:.6f}.png"),
                    (rng.rand(H, W) * 20000 + 500).astype(np.uint16))
        lines["rgb.txt"].append(f"{t:.6f} rgb/{t:.6f}.png")
        lines["depth.txt"].append(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        lines[pose_file].append(f"{t + 0.02:.6f} " + " ".join(
            f"{v:.6f}" for v in np.concatenate([rng.normal(size=3), q])))
    for name, ls in lines.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("# a\n# b\n# c\n" + "\n".join(ls))


def write_7scenes(root, n=3):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(8)
    for i in range(n):
        cv2.imwrite(os.path.join(root, f"frame-{i:06d}.color.png"),
                    texture(H, W, 10 + i).astype(np.uint8))
        cv2.imwrite(os.path.join(root, f"frame-{i:06d}.depth.png"),
                    (rng.rand(H, W) * 4000).astype(np.uint16))
        np.savetxt(os.path.join(root, f"frame-{i:06d}.pose.txt"),
                   np.eye(4) + 0.01 * rng.normal(size=(4, 4)))


def write_rgb_folder(root, n=3):
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    for i in range(n):
        img = texture(H, W, 20 + i).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "rgb", f"{i:04d}.png"),
                    img[..., 0] if i == 1 else img)   # one grey frame


def cfgs(dataset, root, **cam):
    out = []
    for load in (load_config, tload_config):
        cfg = load("configs/wildgs_slam.yaml")
        cfg["dataset"] = dataset
        cfg["data"]["input_folder"] = root
        cfg["cam"].update(H=H, W=W, fx=52.0, fy=51.0, cx=31.5, cy=24.5,
                          H_out=32, W_out=40, H_edge=4, W_edge=4,
                          png_depth_scale=5000.0, **cam)
        out.append(cfg)
    return out


def same_stream(jcfg, tcfg):
    js, ts = jds.get_dataset(jcfg), tds.get_dataset(tcfg)
    assert len(js) == len(ts) > 0
    np.testing.assert_array_equal(ts.intrinsic, js.intrinsic)
    assert (js.poses is None) == (ts.poses is None)
    for i in range(len(js)):
        ji, jc, jd, jp = js[i]
        ti, tc, td, tp = ts[i]
        assert ti == ji and tc.dtype == np.float32
        assert tc.shape == jc.shape == (32, 40, 3)
        assert np.abs(tc - jc).max() <= 1.0 / 255 + 1e-7
        if jd is None:
            assert td is None
        else:
            np.testing.assert_array_equal(td, jd)
        if jp is not None:
            np.testing.assert_array_equal(tp, jp)
    return js, ts


@pytest.mark.parametrize("dataset", ["tumrgbd", "bonn"])
def test_tum_layout_readers(tmp_path, dataset):
    root = str(tmp_path / "seq")
    write_tum(root)
    _, ts = same_stream(*cfgs(dataset, root))
    assert len(ts.poses) == 4


def test_tum_reader_without_ground_truth_file(tmp_path):
    root = str(tmp_path / "seq")
    write_tum(root, pose_file="pose.txt")
    same_stream(*cfgs("tumrgbd", root))


def test_seven_scenes_reader(tmp_path):
    root = str(tmp_path / "7s")
    write_7scenes(root)
    same_stream(*cfgs("7scenes", root))


def test_rgb_folder_reader(tmp_path):
    root = str(tmp_path / "phone")
    write_rgb_folder(root)
    _, ts = same_stream(*cfgs("rgb_nopose", root))
    assert ts.depth_paths is None and ts.poses is None


def write_replica(root, n=3):
    """Replica's layout: results/frame%06d.jpg, results/depth%06d.png,
    traj.txt (one 4x4 camera-to-world row-major per line)."""
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    rng = np.random.RandomState(9)
    lines = []
    for i in range(n):
        cv2.imwrite(os.path.join(root, "results", f"frame{i:06d}.jpg"),
                    texture(H, W, 40 + i).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        cv2.imwrite(os.path.join(root, "results", f"depth{i:06d}.png"),
                    (rng.rand(H, W) * 30000).astype(np.uint16))
        lines.append(" ".join(f"{v:.6f}" for v in
                              (np.eye(4) + 0.01 * rng.normal(size=(4, 4)))
                              .ravel()))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_scannet(root, n=3):
    """ScanNet's layout: color/<i>.jpg, depth/<i>.png, pose/<i>.txt,
    numbered without padding (the readers sort numerically)."""
    for d in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.RandomState(10)
    for i in (0, 2, 10)[:n]:
        cv2.imwrite(os.path.join(root, "color", f"{i}.jpg"),
                    texture(H, W, 50 + i).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])
        cv2.imwrite(os.path.join(root, "depth", f"{i}.png"),
                    (rng.rand(H, W) * 4000).astype(np.uint16))
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"),
                   np.eye(4) + 0.01 * rng.normal(size=(4, 4)))


def test_replica_reader_on_jpeg_frames(tmp_path):
    root = str(tmp_path / "replica")
    write_replica(root)
    _, ts = same_stream(*cfgs("replica", root))
    assert len(ts.poses) == 3


def test_scannet_reader_on_jpeg_frames(tmp_path):
    root = str(tmp_path / "scannet")
    write_scannet(root)
    _, ts = same_stream(*cfgs("scannet", root))
    assert [os.path.basename(p) for p in ts.color_paths] == [
        "0.jpg", "2.jpg", "10.jpg"]


def test_rgb_folder_reader_on_jpeg_frames(tmp_path):
    """Phone folders: .jpg, .JPG and .jpeg beside a .png, progressive and
    grey ones among them."""
    root = str(tmp_path / "phone")
    os.makedirs(os.path.join(root, "rgb"))
    for i, (ext, params) in enumerate((
            (".jpg", []), (".JPG", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
            (".jpeg", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
            (".png", []))):
        img = texture(H, W, 60 + i).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "rgb", f"{i:04d}{ext}"),
                    img[..., 0] if i == 2 else img, params)
    _, ts = same_stream(*cfgs("wild_slam_iphone", root))
    assert len(ts) == 4


def test_undistortion(tmp_path):
    """freiburg2's distortion (configs/Dynamic/TUM_RGBD/
    freiburg2_desk_with_person.yaml) on a 480x640 frame."""
    root = str(tmp_path / "seq")
    os.makedirs(root)
    img = texture(480, 640, 3).astype(np.uint8)
    cv2.imwrite(os.path.join(root, "0000.png"), img)
    jcfg, tcfg = cfgs("rgb_nopose", root)
    for cfg in (jcfg, tcfg):
        cfg["cam"].update(H=480, W=640, fx=520.9, fy=521.0, cx=325.1,
                          cy=249.7, H_out=384, W_out=512, H_edge=8, W_edge=8,
                          distortion=[0.2312, -0.7849, -0.0033, -0.0001,
                                      0.9172])
    jc = jds.get_dataset(jcfg)[0][1]
    tc = tds.get_dataset(tcfg)[0][1]
    diff = np.abs(tc - jc) * 255
    assert diff.max() <= 2.0 + 1e-4, diff.max()


def test_colour_conversion_equals_cv2_imread(tmp_path):
    """What the readers make of colour files that are not 8-bit RGB: a
    16-bit RGB, a grey and an RGBA PNG, as cv2.imread(path) (IMREAD_COLOR)
    makes them."""
    img = png_kinds()["rgb"]
    rng = np.random.RandomState(3)
    for name, a in (("rgb16", rng.randint(0, 65536, img.shape).astype(
            np.uint16)), ("gray", img[..., 0]),
            ("rgba", np.concatenate([img, img[..., :1]], -1))):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, a)
        np.testing.assert_array_equal(
            tds.color_u8(tds.read_image(path)), cv2.imread(path)[..., ::-1],
            err_msg=name)
