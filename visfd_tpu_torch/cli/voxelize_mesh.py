"""voxelize_mesh: closed triangle mesh (PLY) -> binary MRC occupancy
mask.

Capability parity with ``bin/voxelize_mesh/voxelize_mesh.py:35-226``
but implemented from scratch (no pyvista/vtk dependency): voxel
centers are classified by ray-casting parity -- for each (y, z) row a
ray along +x crosses the mesh triangles; voxels before an odd number
of crossings are outside, between odd/even crossings inside.  The
intersection sweep is vectorized over triangles per row.

Flags mirror the reference: -m/--mesh, -o/--out, -i/--in, -w/--width,
-c/--crop (voxel units), -b/--bounds (physical units), -s/--shift
(voxel units).

A copy of ``visfd_tpu/cli/voxelize_mesh.py``.  No device is involved:
the ray parity walks one (y, z) row at a time over the mesh's
triangles, host numpy as in the JAX package.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

from visfd_tpu_torch.io import mrc


def read_ply_mesh(path):
    """Read vertices + triangular faces from ascii or binary_little_
    endian PLY."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for ln in header:
        t = ln.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_vert = int(t[2])
            elif t[1] == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex":
            vert_props.append((t[-1], t[1]))

    np_types = {"float": "f4", "float32": "f4", "double": "f8",
                "float64": "f8", "uchar": "u1", "uint8": "u1",
                "char": "i1", "int": "i4", "int32": "i4", "uint": "u4",
                "short": "i2", "ushort": "u2"}

    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        verts = np.array(
            [[float(v) for v in ln.split()[:len(vert_props)]]
             for ln in text[:n_vert]])
        names = [p[0] for p in vert_props]
        xyz = verts[:, [names.index("x"), names.index("y"),
                        names.index("z")]]
        faces = []
        for ln in text[n_vert:n_vert + n_face]:
            t = [int(v) for v in ln.split()]
            cnt = t[0]
            poly = t[1:1 + cnt]
            for k in range(1, cnt - 1):  # fan triangulation
                faces.append((poly[0], poly[k], poly[k + 1]))
        return xyz, np.asarray(faces, np.int64).reshape(-1, 3)

    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    vdt = np.dtype([(n, "<" + np_types[t]) for n, t in vert_props])
    verts = np.frombuffer(body, dtype=vdt, count=n_vert)
    xyz = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(
        np.float64)
    off = n_vert * vdt.itemsize
    faces = []
    pos = off
    for _ in range(n_face):
        cnt = body[pos]
        pos += 1
        poly = struct.unpack_from(f"<{cnt}i", body, pos)
        pos += 4 * cnt
        for k in range(1, cnt - 1):
            faces.append((poly[0], poly[k], poly[k + 1]))
    return xyz, np.asarray(faces, np.int64).reshape(-1, 3)


def voxelize(verts, faces, shape_zyx, origin_xyz=(0.0, 0.0, 0.0),
             voxel_width=1.0):
    """Occupancy (Z, Y, X) uint8 by +x ray parity at voxel centers."""
    nz, ny, nx = shape_zyx
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    out = np.zeros((nz, ny, nx), np.uint8)
    xs = origin_xyz[0] + np.arange(nx) * voxel_width

    # tiny ray jitter avoids double-counting when a ray passes exactly
    # through a shared triangle edge (standard parity-casting fix)
    # asymmetric so rays never lie on axis-aligned OR diagonal edges
    eps_y = 1.37e-4 * voxel_width
    eps_z = 2.61e-4 * voxel_width
    for iz in range(nz):
        z = origin_xyz[2] + iz * voxel_width + eps_z
        for iy in range(ny):
            y = origin_xyz[1] + iy * voxel_width + eps_y
            # triangle/ray intersection in the (y, z) plane:
            # solve for barycentric coords of the (y, z) projection
            d1y = v1[:, 1] - v0[:, 1]
            d1z = v1[:, 2] - v0[:, 2]
            d2y = v2[:, 1] - v0[:, 1]
            d2z = v2[:, 2] - v0[:, 2]
            det = d1y * d2z - d1z * d2y
            with np.errstate(divide="ignore", invalid="ignore"):
                py = y - v0[:, 1]
                pz = z - v0[:, 2]
                a = (py * d2z - pz * d2y) / det
                b = (d1y * pz - d1z * py) / det
            with np.errstate(invalid="ignore"):
                hit = (np.abs(det) > 1e-12) & (a >= 0) & (b >= 0) \
                    & (a + b <= 1)
            if not hit.any():
                continue
            xh = (v0[hit, 0] + a[hit] * (v1[hit, 0] - v0[hit, 0])
                  + b[hit] * (v2[hit, 0] - v0[hit, 0]))
            xh = np.sort(xh)
            # parity fill between crossing pairs
            inside = np.searchsorted(xh, xs, side="right") % 2 == 1
            out[iz, iy] = inside.astype(np.uint8)
    return out


def run(argv) -> int:
    ap = argparse.ArgumentParser(prog="voxelize_mesh")
    ap.add_argument("-m", "--mesh", dest="fname_mesh", required=True)
    ap.add_argument("-o", "--out", dest="fname_out", required=True)
    ap.add_argument("-i", "--in", dest="fname_mrc_orig")
    ap.add_argument("-w", "--width", dest="voxel_width", type=float)
    ap.add_argument("-c", "--crop", dest="ibounds", type=float, nargs=6)
    ap.add_argument("-b", "--bounds", dest="bounds", type=float, nargs=6)
    ap.add_argument("-s", "--shift", dest="shift", type=float, nargs=3)
    args = ap.parse_args(argv)

    verts, faces = read_ply_mesh(args.fname_mesh)

    w = args.voxel_width
    shape = None
    origin = [0.0, 0.0, 0.0]
    if args.fname_mrc_orig:
        ref = mrc.read_mrc(args.fname_mrc_orig)
        shape = ref.data.shape
        if w is None:
            w = ref.voxel_width_xyz[0] or 1.0
    if w is None:
        w = 1.0
    if args.bounds:
        b = args.bounds
        origin = [b[0], b[2], b[4]]
        shape = (int(np.ceil((b[5] - b[4]) / w)),
                 int(np.ceil((b[3] - b[2]) / w)),
                 int(np.ceil((b[1] - b[0]) / w)))
    elif args.ibounds:
        b = [v * w for v in args.ibounds]
        origin = [b[0], b[2], b[4]]
        shape = (int(round(args.ibounds[5] - args.ibounds[4])) + 1,
                 int(round(args.ibounds[3] - args.ibounds[2])) + 1,
                 int(round(args.ibounds[1] - args.ibounds[0])) + 1)
    if shape is None:
        lo = verts.min(axis=0)
        hi = verts.max(axis=0)
        origin = list(lo)
        shape = tuple(int(np.ceil((hi[d] - lo[d]) / w)) + 1
                      for d in (2, 1, 0))

    if args.shift:
        verts = verts + np.asarray(args.shift) * w

    occ = voxelize(verts, faces, shape, origin, w)
    mrc.write_mrc(args.fname_out, occ.astype(np.float32), voxel_width=w)
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
