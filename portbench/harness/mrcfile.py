"""A minimal mode-2 (float32) MRC writer and reader of the benchmark's
own: it writes the generated tomograms and reads back what the program
wrote, so neither side of a comparison reads through the program's
``io/mrc``.  The 1024-byte header follows the MRC2014 layout (56 words,
then labels)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

HEADER_BYTES = 1024
MODE_FLOAT = 2


@dataclasses.dataclass
class Header:
    nxyz: Tuple[int, int, int]
    mode: int
    cell: Tuple[float, float, float]
    dmin: float
    dmax: float
    dmean: float
    nsymbt: int


def write(path: str, data: np.ndarray, voxel_width: float) -> None:
    """Write (Z, Y, X) float32 ``data`` with a cell of ``voxel_width``
    per voxel."""
    data = np.ascontiguousarray(data, dtype="<f4")
    nz, ny, nx = data.shape
    words = np.zeros(256, "<i4")
    flts = words.view("<f4")
    words[0:3] = (nx, ny, nz)
    words[3] = MODE_FLOAT
    words[7:10] = (nx, ny, nz)
    flts[10:13] = (nx * voxel_width, ny * voxel_width, nz * voxel_width)
    flts[13:16] = 90.0
    words[16:19] = (1, 2, 3)
    flts[19] = data.min()
    flts[20] = data.max()
    flts[21] = data.mean(dtype=np.float64)
    words[52] = int.from_bytes(b"MAP ", "little")
    words[53] = 0x00004444    # little-endian machine stamp
    with open(path, "wb") as fh:
        fh.write(words.tobytes())
        fh.write(data.reshape(-1).view(np.uint8))


def read_header(path: str) -> Header:
    with open(path, "rb") as fh:
        raw = fh.read(HEADER_BYTES)
    if len(raw) < HEADER_BYTES:
        raise ValueError(f"{path}: shorter than an MRC header")
    ints = np.frombuffer(raw, "<i4")
    flts = np.frombuffer(raw, "<f4")
    return Header(nxyz=tuple(int(v) for v in ints[0:3]), mode=int(ints[3]),
                  cell=tuple(float(v) for v in flts[10:13]),
                  dmin=float(flts[19]), dmax=float(flts[20]),
                  dmean=float(flts[21]), nsymbt=int(ints[23]))


def read(path: str) -> Tuple[Header, np.ndarray]:
    """(header, (Z, Y, X) float32 data) of a mode-2 file."""
    h = read_header(path)
    if h.mode != MODE_FLOAT:
        raise ValueError(f"{path}: mode {h.mode}, not {MODE_FLOAT}")
    nx, ny, nz = h.nxyz
    data = np.fromfile(path, "<f4", count=nx * ny * nz,
                       offset=HEADER_BYTES + h.nsymbt)
    if data.size != nx * ny * nz:
        raise ValueError(f"{path}: truncated")
    return h, data.reshape(nz, ny, nx)
