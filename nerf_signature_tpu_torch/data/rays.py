"""Ray generation and camera-pose utilities (host-side numpy; a copy of
``nerf_signature_tpu/data/rays.py``, which the port does not import).

Equivalents of ``get_rays`` (``nerf/utils.py:54-139``), ``nerf_matrix_to_ngp``
(``nerf/provider.py:19-27``) and ``rand_poses`` (``nerf/provider.py:57-91``).

Pixel-index sampling (uniform / patch / error-map importance) happens in
numpy on the host — it is O(num_rays) bookkeeping that would only force tiny
dynamic gathers into the jitted step; direction math is vectorised numpy and
the resulting [N, 3] bundles stream to the device once per step.
"""

import numpy as np


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """Axis swap + scale/offset from nerf-synthetic convention to ngp.
    Ref ``nerf/provider.py:19-27``."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def rand_poses(rng, size, radius=1.0, theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0, 2 * np.pi)):
    """Random orbit-camera poses [size, 4, 4]; ref ``nerf/provider.py:57-91``."""
    thetas = rng.uniform(theta_range[0], theta_range[1], size)
    phis = rng.uniform(phi_range[0], phi_range[1], size)
    centers = np.stack(
        [
            radius * np.sin(thetas) * np.sin(phis),
            radius * np.cos(thetas),
            radius * np.sin(thetas) * np.cos(phis),
        ],
        axis=-1,
    ).astype(np.float32)

    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = -normalize(centers)
    up = np.tile(np.array([0, -1, 0], np.float32), (size, 1))
    right = normalize(np.cross(forward, up))
    up = normalize(np.cross(right, forward))
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses


def get_rays(poses, intrinsics, H, W, N=-1, rng=None, error_map=None,
             patch_size=1, jitter_rng=None):
    """Generate rays for B poses; mirrors ``nerf/utils.py:54-139``.

    poses: [B, 4, 4] cam2world (numpy); intrinsics: (fx, fy, cx, cy).
    N > 0 samples N pixels per pose (uniform / patch / error-map modes);
    N <= 0 returns all H*W rays.  ``jitter_rng``: sub-pixel U(0,1) offsets
    instead of the +0.5 pixel centers — the viewer's progressive
    supersampling path (ref ``nerf/gui.py`` spp accumulation).  Returns
    numpy dict:
      rays_o, rays_d: [B, N, 3]; inds: [B, N]; (inds_coarse when error_map).
    """
    poses = np.asarray(poses, np.float32)
    B = poses.shape[0]
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    results = {}

    if N > 0:
        N = min(N, H * W)
        if rng is None:
            rng = np.random.default_rng()

        if patch_size > 1:
            num_patch = N // (patch_size**2)
            if num_patch * patch_size**2 != N:
                raise ValueError(
                    f"patch mode needs N divisible by patch_size**2 "
                    f"(N={N}, patch_size={patch_size})"
                )
            ix = rng.integers(0, H - patch_size, num_patch)
            iy = rng.integers(0, W - patch_size, num_patch)
            pi, pj = np.meshgrid(
                np.arange(patch_size), np.arange(patch_size), indexing="ij"
            )
            inds = (
                (ix[:, None] + pi.ravel()[None]) * W
                + (iy[:, None] + pj.ravel()[None])
            ).reshape(-1)
            inds = np.broadcast_to(inds, (B, N)).copy()
        elif error_map is None:
            inds = rng.integers(0, H * W, N)
            inds = np.broadcast_to(inds, (B, N)).copy()
        else:
            # importance sampling over the 128x128 error map, ref utils.py:104-114
            em = np.asarray(error_map, np.float64).reshape(B, -1)
            p = em / em.sum(axis=-1, keepdims=True)
            inds_coarse = np.stack(
                [rng.choice(128 * 128, N, replace=False, p=p[b]) for b in range(B)]
            )
            ix, iy = inds_coarse // 128, inds_coarse % 128
            sx, sy = H / 128, W / 128
            ix = np.minimum((ix * sx + rng.random((B, N)) * sx).astype(np.int64), H - 1)
            iy = np.minimum((iy * sy + rng.random((B, N)) * sy).astype(np.int64), W - 1)
            inds = ix * W + iy
            results["inds_coarse"] = inds_coarse
        results["inds"] = inds
        i = (inds % W).astype(np.float32)
        j = (inds // W).astype(np.float32)
    else:
        inds = np.broadcast_to(np.arange(H * W), (B, H * W))
        results["inds"] = inds
        i = (inds % W).astype(np.float32)
        j = (inds // W).astype(np.float32)
    if jitter_rng is None:
        i, j = i + 0.5, j + 0.5
    else:
        i = i + jitter_rng.random(i.shape, dtype=np.float32)
        j = j + jitter_rng.random(j.shape, dtype=np.float32)

    zs = np.ones_like(i)
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    directions = np.stack([xs, ys, zs], axis=-1)
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    rays_d = directions @ np.swapaxes(poses[:, :3, :3], -1, -2)
    rays_o = np.broadcast_to(poses[:, None, :3, 3], rays_d.shape).copy()

    results["rays_o"] = rays_o.astype(np.float32)
    results["rays_d"] = rays_d.astype(np.float32)
    return results
