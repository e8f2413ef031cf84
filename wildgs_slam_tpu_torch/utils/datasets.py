"""Dataset readers (TUM-RGBD, Bonn, 7-Scenes, RGB-only, Replica, ScanNet);
the port's own copy of ``wildgs_slam_tpu/utils/datasets.py``, numpy on the
host.

Images are resized to (W_out + 2 W_edge, H_out + 2 H_edge), the edges
cropped and the intrinsics rescaled to match. ``stream[i]`` returns (index,
colour (H, W, 3) float RGB in [0, 1], depth (H, W) in metres or None,
camera-to-world pose (4, 4) or None).

PNG and JPEG files (any case of .png, .jpg, .jpeg) are decoded by the
port's native library (``native/``: its own C++ decoders, equal to cv2's),
colour frames turned by their EXIF orientation as ``cv2.imread(path)``
does, depth read as stored; any other suffix raises. The port resamples as
cv2 does (``utils/resample.py``): colour bilinear (within one level of
cv2's fixed-point result), depth nearest (exact), undistortion by cv2's
map and a bilinear remap. ``PrefetchingStream`` loads a reader's frames on
worker threads ahead of the caller.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Optional

import numpy as np

from ..native import (Prefetcher, color_u8, read_color,  # noqa: F401
                      read_depth_native, read_image)
from .common import as_intrinsics_matrix
from .resample import resize_u8, undistort


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


class BaseDataset:
    def __init__(self, cfg):
        self.name = cfg["dataset"]
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.n_img = -1
        self.depth_paths = None
        self.color_paths = None
        self.poses = None

        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx_orig, self.fy_orig = cam["fx"], cam["fy"]
        self.cx_orig, self.cy_orig = cam["cx"], cam["cy"]
        self.H_out, self.W_out = cam["H_out"], cam["W_out"]
        self.H_edge, self.W_edge = cam["H_edge"], cam["W_edge"]

        self.H_out_with_edge = self.H_out + self.H_edge * 2
        self.W_out_with_edge = self.W_out + self.W_edge * 2

        intr = np.array([self.fx_orig, self.fy_orig, self.cx_orig,
                         self.cy_orig], np.float64)
        intr[0] *= self.W_out_with_edge / self.W
        intr[1] *= self.H_out_with_edge / self.H
        intr[2] *= self.W_out_with_edge / self.W
        intr[3] *= self.H_out_with_edge / self.H
        intr[2] -= self.W_edge
        intr[3] -= self.H_edge
        self.intrinsic = intr
        self.fx, self.fy, self.cx, self.cy = intr
        self.fovx = focal2fov(self.fx, self.W_out)
        self.fovy = focal2fov(self.fy, self.H_out)

        self.distortion = (np.array(cam["distortion"])
                           if "distortion" in cam else None)

        self.input_folder = cfg["data"]["input_folder"]
        if "ROOT_FOLDER_PLACEHOLDER" in self.input_folder:
            self.input_folder = self.input_folder.replace(
                "ROOT_FOLDER_PLACEHOLDER", cfg["data"]["root_folder"])

    def __len__(self):
        return self.n_img

    def _crop(self, x):
        if self.W_edge > 0:
            x = x[:, self.W_edge:-self.W_edge]
        if self.H_edge > 0:
            x = x[self.H_edge:-self.H_edge]
        return x

    def get_color(self, index):
        color = read_color(self.color_paths[index])
        if self.distortion is not None:
            K = as_intrinsics_matrix(
                [self.fx_orig, self.fy_orig, self.cx_orig, self.cy_orig])
            color = undistort(color, K, self.distortion)
        color = resize_u8(color, (self.H_out_with_edge, self.W_out_with_edge))
        return np.ascontiguousarray(
            self._crop(color.astype(np.float32) / 255.0))

    def get_depth(self, index) -> Optional[np.ndarray]:
        if self.depth_paths is None:
            return None
        return self._crop(read_depth_native(
            self.depth_paths[index], self.W_out_with_edge,
            self.H_out_with_edge, self.png_depth_scale))

    def __getitem__(self, index):
        color = self.get_color(index)
        depth = self.get_depth(index)
        pose = (self.poses[index] if self.poses is not None else None)
        return index, color, depth, pose


class TUM_RGBD(BaseDataset):
    """TUM RGB-D association files: rgb.txt, depth.txt and groundtruth.txt
    (or pose.txt), frames matched within 0.08 s."""

    def __init__(self, cfg, frame_rate=60):  # kept high to use all frames
        super().__init__(cfg)
        self.color_paths, self.depth_paths, self.poses = self.loadtum(
            self.input_folder, frame_rate=frame_rate)
        self.n_img = len(self.color_paths)

    def parse_list(self, filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=str,
                          skiprows=skiprows)

    def associate_frames(self, tstamp_image, tstamp_depth, tstamp_pose,
                         max_dt=0.08):
        associations = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            if tstamp_pose is None:
                if np.abs(tstamp_depth[j] - t) < max_dt:
                    associations.append((i, j))
            else:
                k = np.argmin(np.abs(tstamp_pose - t))
                if (np.abs(tstamp_depth[j] - t) < max_dt and
                        np.abs(tstamp_pose[k] - t) < max_dt):
                    associations.append((i, j, k))
        return associations

    def loadtum(self, datapath, frame_rate=-1):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        elif os.path.isfile(os.path.join(datapath, "pose.txt")):
            pose_list = os.path.join(datapath, "pose.txt")
        else:
            pose_list = None

        image_data = self.parse_list(os.path.join(datapath, "rgb.txt"),
                                     skiprows=3)
        depth_data = self.parse_list(os.path.join(datapath, "depth.txt"),
                                     skiprows=3)
        tstamp_image = image_data[:, 0].astype(np.float64)
        tstamp_depth = depth_data[:, 0].astype(np.float64)

        if pose_list is not None:
            pose_data = self.parse_list(pose_list, skiprows=3)
            pose_vecs = pose_data[:, 1:].astype(np.float64)
            tstamp_pose = pose_data[:, 0].astype(np.float64)
        else:
            pose_vecs, tstamp_pose = None, None

        associations = self.associate_frames(tstamp_image, tstamp_depth,
                                             tstamp_pose)

        indices = [0]
        for i in range(1, len(associations)):
            t0 = tstamp_image[associations[indices[-1]][0]]
            t1 = tstamp_image[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, poses, depths = [], [], []
        inv_pose = None
        for ix in indices:
            a = associations[ix]
            images.append(os.path.join(datapath, image_data[a[0], 1]))
            depths.append(os.path.join(datapath, depth_data[a[1], 1]))
            if pose_vecs is not None:
                c2w = self.pose_matrix_from_quaternion(pose_vecs[a[2]])
                if inv_pose is None:
                    inv_pose = np.linalg.inv(c2w)
                    c2w = np.eye(4)
                else:
                    c2w = inv_pose @ c2w
                poses.append(c2w.astype(np.float32))

        return images, depths, (poses if poses else None)

    @staticmethod
    def pose_matrix_from_quaternion(pvec):
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


class BONN(TUM_RGBD):
    """Bonn dynamic: TUM layout, ground truth in another axis convention."""

    def loadtum(self, datapath, frame_rate=-1):
        images, depths, poses = super().loadtum(datapath, frame_rate)
        if poses is not None:
            M = np.array([
                [1.0157, 0.1828, -0.2389, 0.0113],
                [-0.0009, -0.8431, -0.6413, -0.0098],
                [-0.3009, 0.6147, -0.8085, 0.0111],
                [0, 0, 0, 1.0],
            ])
            poses = [np.linalg.inv(M) @ p @ M for p in poses]
        return images, depths, poses


class SevenScenes(BaseDataset):
    """7-Scenes: frame-%06d.{color,depth}.png and .pose.txt per frame."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "*.color.png")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "*.depth.png")))
        pose_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "*.pose.txt")))
        self.poses = [np.loadtxt(p).astype(np.float32) for p in pose_paths] \
            or None
        self.n_img = len(self.color_paths)


class RGB_NoPose(BaseDataset):
    """A folder of images (or its rgb/ subfolder): no depth, no poses."""

    def __init__(self, cfg):
        super().__init__(cfg)
        exts = ("*.png", "*.jpg", "*.jpeg", "*.JPG", "*.PNG")
        paths = []
        for e in exts:
            paths += glob.glob(os.path.join(self.input_folder, e))
            paths += glob.glob(os.path.join(self.input_folder, "rgb", e))
        self.color_paths = sorted(set(paths))
        self.depth_paths = None
        self.poses = None
        self.n_img = len(self.color_paths)


class Replica(BaseDataset):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self.load_poses(f"{self.input_folder}/traj.txt")

    def load_poses(self, path):
        poses = []
        with open(path) as f:
            lines = f.readlines()
        for i in range(self.n_img):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            poses.append(c2w.astype(np.float32))
        self.poses = poses


class ScanNet(BaseDataset):
    def __init__(self, cfg):
        super().__init__(cfg)
        base = self.input_folder
        self.color_paths = sorted(
            glob.glob(os.path.join(base, "color", "*.jpg")),
            key=lambda x: int(os.path.basename(x)[:-4]))
        self.depth_paths = sorted(
            glob.glob(os.path.join(base, "depth", "*.png")),
            key=lambda x: int(os.path.basename(x)[:-4]))
        pose_paths = sorted(
            glob.glob(os.path.join(base, "pose", "*.txt")),
            key=lambda x: int(os.path.basename(x)[:-4]))
        self.poses = [np.loadtxt(p).astype(np.float32)
                      for p in pose_paths] or None
        self.n_img = len(self.color_paths)


class PrefetchingStream:
    """A reader whose frames `n_threads` worker threads load ahead of the
    caller, `lookahead` frames past the last one asked for (the native
    ``Prefetcher``). ``stream[i]`` equals ``ds[i]``: the workers call the
    reader itself, undistortion included. Other attributes are the
    reader's."""

    def __init__(self, ds: BaseDataset, n_threads: int = 2,
                 lookahead: int = 4):
        self.ds = ds
        self._pool = Prefetcher(ds.__getitem__, len(ds), n_threads,
                                lookahead)

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):
        if name in ("ds", "_pool"):   # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.ds, name)

    def __getitem__(self, index):
        return self._pool.get(index)

    def close(self):
        self._pool.close()


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUM_RGBD,
    "bonn": BONN,
    "bonn_dynamic": BONN,
    "wild_slam_mocap": TUM_RGBD,
    "7scenes": SevenScenes,
    "rgb_nopose": RGB_NoPose,
    "wild_slam_iphone": RGB_NoPose,
}


def get_dataset(cfg):
    return dataset_dict[cfg["dataset"]](cfg)


def load_metric_depth(frame_idx, save_dir):
    path = os.path.join(save_dir, "mono_priors", "depths",
                        f"{frame_idx:05d}.npy")
    return np.load(path)


def load_img_feature(frame_idx, save_dir, suffix=""):
    path = os.path.join(save_dir, "mono_priors", "features",
                        f"{frame_idx:05d}{suffix}.npy")
    return np.load(path)
