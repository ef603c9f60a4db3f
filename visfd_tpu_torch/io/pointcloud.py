"""Oriented point-cloud export (PLY / OBJ).

Port of ``visfd_tpu/io/pointcloud.py`` (``WriteOrientedPointCloudPLY`` /
``...OBJ``, ``bin/filter_mrc/file_io.hpp:498-565``): ascii PLY with x y
z nx ny nz vertex properties, or a Wavefront OBJ with v / vn rows.
"""

from __future__ import annotations

import numpy as np

from visfd_tpu_torch.io.coords import fmt_g


def write_oriented_pointcloud_ply(path, coords, normals):
    coords = np.asarray(coords).reshape(-1, 3)
    normals = np.asarray(normals).reshape(-1, 3)
    if len(coords) != len(normals):
        raise ValueError(f"{len(coords)} coordinates but {len(normals)} "
                         f"normals")
    with open(path, "w") as f:
        f.write(
            "ply\n"
            "format ascii 1.0\n"
            "comment  created by visfd\n"
            f"element vertex {len(coords)}\n"
            "property float x\n"
            "property float y\n"
            "property float z\n"
            "property float nx\n"
            "property float ny\n"
            "property float nz\n"
            "end_header\n")
        for (x, y, z), (nx, ny, nz) in zip(coords, normals):
            f.write(f"{fmt_g(x)} {fmt_g(y)} {fmt_g(z)} "
                    f"{fmt_g(nx)} {fmt_g(ny)} {fmt_g(nz)}\n")


def write_oriented_pointcloud_obj(path, coords, normals):
    coords = np.asarray(coords).reshape(-1, 3)
    normals = np.asarray(normals).reshape(-1, 3)
    if len(coords) != len(normals):
        raise ValueError(f"{len(coords)} coordinates but {len(normals)} "
                         f"normals")
    with open(path, "w") as f:
        f.write("# WaveFront *.obj file created by visfd\n\ng obj1_\n\n")
        for x, y, z in coords:
            f.write(f"v {fmt_g(x)} {fmt_g(y)} {fmt_g(z)}\n")
        f.write("\n")
        for nx, ny, nz in normals:
            f.write(f"vn {fmt_g(nx)} {fmt_g(ny)} {fmt_g(nz)}\n")


def read_ply_pointcloud(path):
    """Read back an ascii PLY oriented point cloud: (coords, normals)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = 0
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        if ln.strip() == "end_header":
            body = lines[i + 1: i + 1 + n]
            break
    else:
        raise ValueError("not a PLY file")
    data = np.asarray([[float(v) for v in ln.split()] for ln in body])
    return data.reshape(-1, 6)[:, :3], data.reshape(-1, 6)[:, 3:6]
