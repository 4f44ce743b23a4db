"""Clean NeRF dataset provider (Blender / colmap transforms.json formats); a
copy of ``nerf_signature_tpu/data/provider.py`` with OpenCV imported lazily.

Equivalent of ``nerf/provider.py:94-332``:
  * auto-detects ``transforms.json`` (colmap mode) vs ``transforms_train.json``
    (blender mode),
  * modes train / val / test / all / trainval; colmap test poses are slerp
    interpolations between two random frames; colmap train/val split is
    all-but-first / first frame,
  * ``nerf_matrix_to_ngp`` pose convention with scale/offset,
  * intrinsics from fl_x/fl_y or camera_angle_x/y,
  * optional 128x128 error map for importance sampling,
  * ``rand_pose`` mixing returns low-res full-image ray bundles (CLIP mode).

Images are decoded with cv2 (BGR->RGB, INTER_AREA resize, /255) exactly like
the reference; batches are plain numpy dicts that the trainer ships to device.
"""

import glob
import json
import os

import numpy as np

from .rays import get_rays, nerf_matrix_to_ngp, rand_poses



def _cv2():
    """OpenCV, imported when an image is first decoded."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "NeRFDataset decodes images with OpenCV (cv2), which is not "
            "installed; install opencv-python or build rays without the "
            "image provider") from e
    return cv2


def _load_image(path, H=None, W=None):
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    elif img.ndim == 3 and img.shape[-1] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    if H is not None and (img.shape[0] != H or img.shape[1] != W):
        img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    return img.astype(np.float32) / 255.0


def _slerp_poses(pose0, pose1, n, ratios=None):
    """Slerp rotation + lerp translation between two ngp poses."""
    from scipy.spatial.transform import Rotation, Slerp

    rots = Rotation.from_matrix(np.stack([pose0[:3, :3], pose1[:3, :3]]))
    slerp = Slerp([0, 1], rots)
    if ratios is None:
        ratios = [
            np.sin(((i / max(n - 1, 1)) - 0.5) * np.pi) * 0.5 + 0.5
            for i in range(n)
        ]
    poses = []
    for r in ratios:
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = slerp(r).as_matrix().astype(np.float32)
        p[:3, 3] = (1 - r) * pose0[:3, 3] + r * pose1[:3, 3]
        poses.append(p)
    return np.stack(poses)


class NeRFDataset:
    """Iterable provider; one batch == one pose's sampled rays (B=1), matching
    the reference's DataLoader-over-indices with a custom collate."""

    def __init__(self, opt, type="train", downscale=1, n_test=10, seed=None):
        self.opt = opt
        self.type = type
        self.downscale = downscale
        self.root_path = opt.path
        self.scale = opt.scale
        self.offset = opt.offset
        self.bound = opt.bound
        self.training = type in ("train", "all", "trainval")
        self.num_rays = opt.num_rays if self.training else -1
        self.rand_pose = getattr(opt, "rand_pose", -1)
        self.patch_size = getattr(opt, "patch_size", 1)
        self.rng = np.random.default_rng(seed if seed is not None else opt.seed)

        if os.path.exists(os.path.join(self.root_path, "transforms.json")):
            self.mode = "colmap"
        elif os.path.exists(os.path.join(self.root_path, "transforms_train.json")):
            self.mode = "blender"
        else:
            raise NotImplementedError(
                f"[NeRFDataset] no transforms*.json under {self.root_path}"
            )

        if self.mode == "colmap":
            with open(os.path.join(self.root_path, "transforms.json")) as f:
                transform = json.load(f)
        else:
            if type == "all":
                transform = None
                for p in glob.glob(os.path.join(self.root_path, "*.json")):
                    with open(p) as f:
                        t = json.load(f)
                    if transform is None:
                        transform = t
                    else:
                        transform["frames"].extend(t["frames"])
            elif type == "trainval":
                with open(os.path.join(self.root_path, "transforms_train.json")) as f:
                    transform = json.load(f)
                with open(os.path.join(self.root_path, "transforms_val.json")) as f:
                    transform["frames"].extend(json.load(f)["frames"])
            else:
                with open(
                    os.path.join(self.root_path, f"transforms_{type}.json")
                ) as f:
                    transform = json.load(f)

        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // int(downscale)
            self.W = int(transform["w"]) // int(downscale)
        else:
            self.H = self.W = None

        frames = transform["frames"]

        if self.mode == "colmap" and type == "test":
            if self.H is None:
                # transforms.json without w/h (colmap2nerf always writes
                # them, but hand-written ones may not): probe a frame image
                for f in frames:
                    f_path = os.path.join(self.root_path, f["file_path"])
                    if os.path.exists(f_path):
                        probe = _cv2().imread(f_path, -1)
                        self.H = int(probe.shape[0] // downscale)
                        self.W = int(probe.shape[1] // downscale)
                        break
            f0, f1 = self.rng.choice(frames, 2, replace=False)
            p0 = nerf_matrix_to_ngp(
                np.array(f0["transform_matrix"], np.float32), self.scale, self.offset
            )
            p1 = nerf_matrix_to_ngp(
                np.array(f1["transform_matrix"], np.float32), self.scale, self.offset
            )
            self.poses = _slerp_poses(p0, p1, n_test + 1)
            self.images = None
        else:
            if self.mode == "colmap":
                if type == "train":
                    frames = frames[1:]
                elif type == "val":
                    frames = frames[:1]
            poses, images = [], []
            for f in frames:
                f_path = os.path.join(self.root_path, f["file_path"])
                if self.mode == "blender" and "." not in os.path.basename(f_path):
                    f_path += ".png"
                if not os.path.exists(f_path):
                    continue
                pose = nerf_matrix_to_ngp(
                    np.array(f["transform_matrix"], np.float32),
                    self.scale, self.offset,
                )
                if self.H is None:
                    probe = _cv2().imread(f_path, -1)
                    self.H = int(probe.shape[0] // downscale)
                    self.W = int(probe.shape[1] // downscale)
                images.append(_load_image(f_path, self.H, self.W))
                poses.append(pose)
            self.poses = np.stack(poses)
            self.images = np.stack(images) if images else None

        self.radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())

        if self.training and getattr(opt, "error_map", False):
            self.error_map = np.ones(
                (len(self.poses), 128 * 128), dtype=np.float32
            )
        else:
            self.error_map = None

        # intrinsics (ref provider.py:259-274)
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (
                self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                if "camera_angle_x" in transform else None
            )
            fl_y = (
                self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                if "camera_angle_y" in transform else None
            )
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("Failed to load focal length from transforms.json")
        cx = transform.get("cx", self.W / 2) / downscale if "cx" in transform else self.W / 2
        cy = transform.get("cy", self.H / 2) / downscale if "cy" in transform else self.H / 2
        self.intrinsics = np.array([fl_x, fl_y, cx, cy])

        self.has_gt = self.images is not None

    def __len__(self):
        size = len(self.poses)
        if self.training and self.rand_pose > 0:
            size += size // self.rand_pose
        return size

    def collate(self, index):
        """index: int.  Returns a numpy batch dict (B=1)."""
        if self.rand_pose == 0 or index >= len(self.poses):
            poses = rand_poses(self.rng, 1, radius=self.radius)
            s = np.sqrt(self.H * self.W / self.num_rays)
            rH, rW = int(self.H / s), int(self.W / s)
            rays = get_rays(poses, self.intrinsics / s, rH, rW, -1)
            return {"H": rH, "W": rW, "rays_o": rays["rays_o"],
                    "rays_d": rays["rays_d"]}

        poses = self.poses[index : index + 1]
        error_map = None if self.error_map is None else self.error_map[index : index + 1]
        rays = get_rays(
            poses, self.intrinsics, self.H, self.W, self.num_rays,
            rng=self.rng, error_map=error_map, patch_size=self.patch_size,
        )
        results = {
            "H": self.H, "W": self.W,
            "rays_o": rays["rays_o"], "rays_d": rays["rays_d"],
        }
        if self.images is not None:
            images = self.images[index : index + 1]  # [1, H, W, C]
            if self.training:
                C = images.shape[-1]
                images = np.take_along_axis(
                    images.reshape(1, -1, C), rays["inds"][..., None], axis=1
                )
            results["images"] = images
        if error_map is not None:
            results["index"] = index
            results["inds_coarse"] = rays["inds_coarse"]
        return results

    def __iter__(self):
        order = np.arange(len(self))
        if self.training:
            self.rng.shuffle(order)
        for idx in order:
            yield self.collate(int(idx))

    def dataloader(self):
        return self
