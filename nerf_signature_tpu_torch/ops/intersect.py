"""Ray/AABB and ray/sphere intersections (plain PyTorch).

Counterpart of ``nerf_signature_tpu/ops/intersect.py``.  On the render path
the slab test runs as the prologue of the marcher kernel
(``ops.marching.march_rays_aabb``) and the sphere's exit point inside K8
(``ops.hashenc.bg_encode``); these are their plain versions.
"""

import math

import torch

_MISS = 3.4028234663852886e38  # float32 max: the reference kernel's miss sentinel


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.2):
    """rays_o, rays_d: [N, 3]; aabb: [6] (xmin, ymin, zmin, xmax, ymax, zmax).
    Returns (nears, fars) [N]; misses get near == far == float32 max, hits
    clamp near to ``min_near``."""
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=rays_o.device)
    inv_d = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = torch.clamp_min(near, min_near)
    near = torch.where(miss, _MISS, near)
    far = torch.where(miss, _MISS, far)
    return near, far


def sph_from_ray(rays_o, rays_d, radius):
    """Far ray/sphere(radius) intersection -> (theta, phi) scaled to [-1, 1]
    (the discriminant clamped at 0).  The plain twin of the sphere point K8
    computes inside its kernels (``csrc/hashenc_bg.cu:bg_position``)."""
    a = torch.sum(rays_d * rays_d, dim=-1)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1)
    c = torch.sum(rays_o * rays_o, dim=-1) - radius * radius
    disc = torch.clamp_min(b * b - 4 * a * c, 0.0)
    t = (-b + torch.sqrt(disc)) / (2 * a)
    p = rays_o + t[..., None] * rays_d
    theta = torch.atan2(torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2), p[..., 2]) / math.pi
    phi = torch.atan2(p[..., 1], p[..., 0]) / math.pi
    return torch.stack([2.0 * theta - 1.0, phi], dim=-1)
