"""Density-field extraction and mesh export (counterpart of
``nerf_signature_tpu/meshing/extract.py``): chunked density queries over a
lattice (through the field's kernels on the card), native marching cubes,
rescale to world, write PLY/OBJ."""

import numpy as np
import torch

from .marching_cubes import marching_cubes


def extract_fields(bound_min, bound_max, resolution, query_fn, chunk=128**2):
    """query_fn: [M, 3] numpy -> [M] sigmas.  Returns [res, res, res] float32."""
    xs = np.linspace(bound_min[0], bound_max[0], resolution, dtype=np.float32)
    ys = np.linspace(bound_min[1], bound_max[1], resolution, dtype=np.float32)
    zs = np.linspace(bound_min[2], bound_max[2], resolution, dtype=np.float32)
    u = np.zeros((resolution, resolution, resolution), np.float32)
    yy, zz = np.meshgrid(ys, zs, indexing="ij")
    for xi, x in enumerate(xs):
        pts = np.stack(
            [np.full(yy.size, x, np.float32), yy.ravel(), zz.ravel()], axis=-1)
        vals = [np.asarray(query_fn(pts[h:h + chunk]))
                for h in range(0, pts.shape[0], chunk)]
        u[xi] = np.concatenate(vals).reshape(resolution, resolution)
    return u


def extract_geometry(bound_min, bound_max, resolution, threshold, query_fn):
    u = extract_fields(bound_min, bound_max, resolution, query_fn)
    verts, tris = marching_cubes(u, threshold)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    verts = verts / (resolution - 1.0) * (bmax - bmin)[None] + bmin[None]
    return verts, tris


def write_ply(path, verts, tris):
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(verts.astype("<f4").tobytes())
        face_dt = np.dtype([("n", "u1"), ("i", "<i4", 3)])
        faces = np.empty(len(tris), face_dt)
        faces["n"] = 3
        faces["i"] = tris
        f.write(faces.tobytes())


def write_obj(path, verts, tris):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def save_mesh(model, path, resolution=256, threshold=10.0):
    """Mesh of the model's density field (ref ``Trainer.save_mesh``)."""
    b = model.rc.bound

    def query(pts):
        x = torch.from_numpy(pts).to(model.device)
        return model.density_fn(x).cpu().numpy()

    verts, tris = extract_geometry([-b, -b, -b], [b, b, b], resolution,
                                   threshold, query)
    if path.endswith(".obj"):
        write_obj(path, verts, tris)
    else:
        write_ply(path, verts, tris)
    return verts, tris
