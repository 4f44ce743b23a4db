"""Watermark-stage dataset provider (self-distillation and the secret keys);
a copy of ``nerf_signature_tpu/data/provider_wtmk.py`` that renders through
the port's model.

  * poses and intrinsics come from the Blender/colmap transforms file; no
    photo is read: every ground truth is RENDERED by the frozen model
    (pseudo-GT), cached in ``--pseudo_gt_cache`` (an npz fingerprinted
    against the backbone, the poses, the intrinsics, H, W and the budget);
  * the key poses: ``n_views`` random orbit poses (or as many copies of the
    first train pose with ``use_existset``), loaded from or saved to
    ``key_poses.npy`` (a file of V rows sets V);
  * the key blocks: view 0's key render cut into num_rows x num_cols blocks,
    the ``message_dim`` least JPEG-compressible (PIL, q = 75) or random
    ones, loaded from or saved to ``key_blocks.npy``;
  * the block ray bundles and crops, [D, bh, bw, 3] with one key view and
    [D, V, bh, bw, 3] with V (the same blocks cut from every view's render:
    the multi-view decoder reads them channel-concatenated);
  * modes train / test (bit accuracy) / test_image (random slerp poses) /
    test_image_testviews (the test split's poses).

A transforms file that carries ``h``/``w`` needs no image at all; otherwise
the first frame's size is read with OpenCV.  PIL is imported only to score
blocks by JPEG ratio.
"""

import io
import json
import os
import time

import numpy as np
import torch

from .provider import _slerp_poses
from .rays import get_rays, nerf_matrix_to_ngp, rand_poses


def calculate_compression_ratio(blocks):
    """blocks: [n, bh, bw, 3] float in [0,1].  JPEG(q=75) original/compressed
    size ratio per block; ref ``provider_wtmk.py:146-170``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "JPEG-ratio key-block selection encodes blocks with PIL, which is not "
            "installed: pass --block_selection random, or key blocks in "
            "<workspace>/key_blocks.npy") from e
    ratios = []
    for b in blocks:
        img = Image.fromarray((np.clip(b, 0, 1) * 255).astype(np.uint8))
        buf0, buf1 = io.BytesIO(), io.BytesIO()
        img.save(buf0, format="JPEG")
        img.save(buf1, format="JPEG", optimize=True, quality=75)
        ratios.append(buf0.tell() / max(buf1.tell(), 1))
    return np.array(ratios)


def select_key_blocks(image, num_rows, num_cols, num_selections, selection="jpeg", rng=None):
    """image [H, W, 3] -> block coordinates [k, 4] (x0, y0, x1, y1), bh, bw.

    'jpeg' (paper): the k lowest-compression-ratio (most textured) blocks;
    'random': k distinct uniform-random blocks."""
    H, W = image.shape[:2]
    bh, bw = H // num_rows, W // num_cols
    if selection != "random" and float(np.std(image)) < 1e-3:
        raise ValueError(
            "key image is (near-)constant — the key-pose render produced no "
            "content, so JPEG-ratio block selection is meaningless.  Check "
            "the loaded checkpoint (occupancy grid / density_thresh).")
    if selection == "random":
        rng = rng or np.random.default_rng()
        sel = rng.choice(num_rows * num_cols, num_selections, replace=False)
    else:
        blocks = (image[: bh * num_rows, : bw * num_cols]
                  .reshape(num_rows, bh, num_cols, bw, 3)
                  .transpose(0, 2, 1, 3, 4)
                  .reshape(-1, bh, bw, 3))
        sel = np.argsort(calculate_compression_ratio(blocks))[:num_selections]
    rows, cols = sel // num_cols, sel % num_cols
    coords = np.stack([rows * bh, cols * bw, (rows + 1) * bh, (cols + 1) * bw], axis=1)
    return coords.astype(np.int64), bh, bw


def _random_slerp_poses(rng, n, frames, scale, offset):
    """n random poses, each a random-ratio slerp between two random frames."""
    out = []
    for _ in range(n):
        f0, f1 = rng.choice(frames, 2, replace=False)
        p0 = nerf_matrix_to_ngp(np.array(f0["transform_matrix"], np.float32), scale, offset)
        p1 = nerf_matrix_to_ngp(np.array(f1["transform_matrix"], np.float32), scale, offset)
        out.append(_slerp_poses(p0, p1, 1, ratios=[rng.random()])[0])
    return np.stack(out)


def _backbone_sum(model):
    """sum |leaf| over the frozen model's tensors (the pseudo-GT cache's
    fingerprint of the backbone)."""
    tree = getattr(model, "backbone", None) or model.params
    leaves = [v for k in sorted(tree) for v in (tree[k] if isinstance(tree[k], list)
                                                 else [tree[k]])]
    return float(sum(float(torch.sum(torch.abs(t.float()))) for t in leaves))


class NeRFDatasetDisen:
    def __init__(self, opt, keyposes_dir, keyposes_save_dir, keyblocks_dir,
                 keyblocks_save_dir, pretrained_model, downscale=1, type="train",
                 n_views=1, n_test=48, message_dim=16, num_rows=16, num_cols=16,
                 use_existset=False, seed=None):
        self.opt = opt
        self.type = type
        self.downscale = downscale
        self.root_path = opt.path
        self.scale = opt.scale
        self.offset = opt.offset
        self.bound = opt.bound
        self.training = type == "train"
        self.num_rays = opt.num_rays if self.training else -1
        self.model = pretrained_model
        self.n_test = n_test
        self.n_views = n_views
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.message_dim = message_dim
        self.patch_size = getattr(opt, "patch_size", 1)
        self.rng = np.random.default_rng(seed if seed is not None else opt.seed)

        split = "test" if type == "test_image_testviews" else "train"
        tpath = os.path.join(self.root_path, f"transforms_{split}.json")
        if not os.path.exists(tpath):
            tpath = os.path.join(self.root_path, "transforms.json")
        with open(tpath) as f:
            transform = json.load(f)

        if "h" in transform and "w" in transform:
            self.H = int(transform["h"] // downscale)
            self.W = int(transform["w"] // downscale)
        else:
            self.H = self.W = None

        frames = transform["frames"]
        self.frames = frames
        poses = []
        for fr in frames:
            pose = nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                                      self.scale, self.offset)
            if self.H is None:
                from .provider import _cv2
                cv2 = _cv2()
                f_path = os.path.join(self.root_path, fr["file_path"])
                if "." not in os.path.basename(f_path):
                    f_path += ".png"
                probe = cv2.imread(f_path, cv2.IMREAD_UNCHANGED)
                self.H = int(probe.shape[0] // downscale)
                self.W = int(probe.shape[1] // downscale)
            poses.append(pose)
        self.poses = np.stack(poses)
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())

        # intrinsics
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        else:
            fl_x = (self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                    if "camera_angle_x" in transform else None)
            fl_y = (self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                    if "camera_angle_y" in transform else None)
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        cx = transform.get("cx", self.W / 2) / (downscale if "cx" in transform else 1)
        cy = transform.get("cy", self.H / 2) / (downscale if "cy" in transform else 1)
        if "cx" not in transform:
            cx, cy = self.W / 2, self.H / 2
        self.intrinsics = np.array([fl_x, fl_y, cx, cy])
        self.error_map = None

        # ---- pseudo-GT for every train pose (self-distillation)
        self.train_images = self._pseudo_gt_cached() if type == "train" else None

        # ---- secret key material
        if type in ("train", "test"):
            V = max(1, n_views)
            if keyposes_dir is None:
                if use_existset:
                    wp = np.repeat(self.poses[0:1], V, axis=0)
                else:
                    wp = rand_poses(self.rng, V, radius=self.radius)
                self.watermark_poses = wp
                if keyposes_save_dir is not None:
                    if os.path.exists(keyposes_save_dir):
                        raise ValueError("Key poses file exists!")
                    np.save(keyposes_save_dir, wp)
            else:
                self.watermark_poses = np.load(keyposes_dir)
                V = self.watermark_poses.shape[0]

            rays = get_rays(self.watermark_poses, self.intrinsics, self.H, self.W, -1)
            imgs = np.stack([self._render_rays(rays["rays_o"][v], rays["rays_d"][v]).reshape(
                self.H, self.W, 3) for v in range(V)])  # [V, H, W, 3]
            self.watermark_images = imgs[:1]  # view 0
            self.watermark_images_views = imgs
            self.rays = {"rays_o": rays["rays_o"].reshape(V, self.H, self.W, 3),
                         "rays_d": rays["rays_d"].reshape(V, self.H, self.W, 3)}

            if keyblocks_dir is None:
                # scored and selected on view 0
                coords, bh, bw = select_key_blocks(
                    imgs[0], num_rows, num_cols, message_dim,
                    selection=getattr(opt, "block_selection", "jpeg"), rng=self.rng)
                self.block_coordinates = coords
                if keyblocks_save_dir is not None:
                    if os.path.exists(keyblocks_save_dir):
                        raise ValueError("Key blocks file exists!")
                    np.save(keyblocks_save_dir, coords)
            else:
                self.block_coordinates = np.load(keyblocks_dir)
                bh = self.H // num_rows
                bw = self.W // num_cols

            blocks, ro_b, rd_b = [], [], []
            for i in range(message_dim):
                x0, y0, x1, y1 = self.block_coordinates[i]
                blocks.append(imgs[:, x0:x1, y0:y1])  # [V, bh, bw, 3]
                ro_b.append(self.rays["rays_o"][:, x0:x1, y0:y1])
                rd_b.append(self.rays["rays_d"][:, x0:x1, y0:y1])
            self.images_block_views = np.stack(blocks)  # [D, V, bh, bw, 3]
            self.images_block = self.images_block_views[:, 0]  # [D, bh, bw, 3]
            ro_b, rd_b = np.stack(ro_b), np.stack(rd_b)  # [D, V, bh, bw, 3]
            self.rays_o_block = ro_b[:, 0] if V == 1 else ro_b
            self.rays_d_block = rd_b[:, 0] if V == 1 else rd_b
            self.patch_H, self.patch_W = bh, bw
        else:
            if type == "test_image":
                self.image_poses = _random_slerp_poses(self.rng, n_views, frames, self.scale,
                                                       self.offset)
            elif type == "test_image_testviews":
                self.image_poses = self.poses
            else:
                raise NotImplementedError(f"Wrong type: {type}")
            self.content_images = self._render_poses(self.image_poses, desc=f"{type} renders")
            self.rays = get_rays(self.image_poses, self.intrinsics, self.H, self.W, -1)
            self.block_coordinates = None
            self.images_block = None
            self.rays_o_block = self.rays_d_block = None
            self.patch_H = self.patch_W = None

    # ------------------------------------------------------------------
    def _render_rays(self, rays_o, rays_d):
        out = self.model.render(rays_o, rays_d, None, staged=True,
                                max_ray_batch=getattr(self.opt, "max_ray_batch", 4096))
        return out["image"].float().cpu().numpy()

    def _pseudo_gt_cached(self):
        """The pseudo-GT pool, through the ``--pseudo_gt_cache`` npz when
        its fingerprint (backbone, poses, intrinsics, H, W, budget) matches;
        a stale or unreadable cache is re-rendered."""
        cache = getattr(self.opt, "pseudo_gt_cache", None)
        fp = None
        if cache:
            fp = np.array([_backbone_sum(self.model), float(np.abs(self.poses).sum()),
                           float(np.abs(self.intrinsics).sum()), self.H, self.W,
                           float(getattr(self.model, "infer_budget", 0))], np.float64)
            if os.path.exists(cache):
                imgs = None
                try:
                    data = np.load(cache)
                    match = np.allclose(data["fingerprint"], fp, rtol=1e-6)
                    imgs = data["images"] if match else None
                except (OSError, ValueError, KeyError) as e:
                    print(f"[pseudo-GT] cache {cache} unreadable ({type(e).__name__}: {e}); "
                          "re-rendering")
                else:
                    print(f"[pseudo-GT] loaded cache {cache}" if match else
                          f"[pseudo-GT] cache {cache} stale (backbone/pose mismatch); "
                          "re-rendering")
                if imgs is not None:
                    return imgs
        images = self._render_poses(self.poses, desc="pseudo-GT")
        if cache:
            tmp = cache + ".tmp.npz"
            np.savez_compressed(tmp, images=images, fingerprint=fp)
            os.replace(tmp, cache)
            print(f"[pseudo-GT] saved cache {cache}")
        return images

    def _render_poses(self, poses, desc=""):
        images = []
        if desc:
            print(f"[{desc}] rendering {len(poses)} views ({self.H}x{self.W})...", flush=True)
        t0 = time.time()
        for i in range(len(poses)):
            rays = get_rays(poses[i:i + 1], self.intrinsics, self.H, self.W, -1)
            img = self._render_rays(rays["rays_o"][0], rays["rays_d"][0])
            images.append(img.reshape(self.H, self.W, 3))
            if desc and (i + 1) % 5 == 0:
                rate = (i + 1) / max(time.time() - t0, 1e-9)
                print(f"[{desc}] rendered {i + 1}/{len(poses)} views "
                      f"(eta {(len(poses) - i - 1) / rate:.0f}s)", flush=True)
        return np.stack(images)

    # ------------------------------------------------------------------
    def _watermark_dict(self):
        return {
            "H": self.H, "W": self.W,
            "rays_o": self.rays["rays_o"], "rays_d": self.rays["rays_d"],
            "images": self.watermark_images,
            "block_coordinates": self.block_coordinates,
            "patch_H": self.patch_H, "patch_W": self.patch_W,
            "images_block": self.images_block,
            "rays_o_block": self.rays_o_block,
            "rays_d_block": self.rays_d_block,
        }

    def collate(self, index):
        """A train batch: the watermark dict and fresh content rays of pose
        ``index`` with their pseudo-GT pixels."""
        rays = get_rays(self.poses[index:index + 1], self.intrinsics, self.H, self.W,
                        self.num_rays, rng=self.rng, patch_size=self.patch_size)
        content = {"H": self.H, "W": self.W, "rays_o": rays["rays_o"],
                   "rays_d": rays["rays_d"]}
        if self.train_images is not None:
            imgs = self.train_images[index:index + 1].reshape(1, -1, 3)
            content["images"] = np.take_along_axis(imgs, rays["inds"][..., None], axis=1)
        return {"watermark": self._watermark_dict(), "content": content}

    def collate_bitacc(self, index):
        return {"watermark": self._watermark_dict()}

    def collate_image(self, index):
        i = index
        return {
            "H": self.H, "W": self.W,
            "rays_o": self.rays["rays_o"][i:i + 1],
            "rays_d": self.rays["rays_d"][i:i + 1],
            "images": self.content_images[i:i + 1],
        }

    def __len__(self):
        if self.type == "train":
            return len(self.poses)
        if self.type == "test":
            return self.n_test
        return len(self.image_poses)

    def __iter__(self):
        if self.type == "train":
            order = np.arange(len(self))
            self.rng.shuffle(order)
            for i in order:
                yield self.collate(int(i))
        elif self.type == "test":
            for i in range(self.n_test):
                yield self.collate_bitacc(i)
        else:
            for i in range(len(self)):
                yield self.collate_image(i)

    def dataloader(self):
        self.has_gt = True
        return self
