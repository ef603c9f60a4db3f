"""MRC/REC tomogram file I/O.

Capability parity with the reference's ``lib/mrc_simple``
(``mrc_header.hpp:24-142``, ``mrc_simple.cpp:104-490``):

* 1024-byte header; words 0-2 = nvoxels (NX,NY,NZ), word 3 = mode,
  words 4-6 = nstart, 7-9 = mvoxels, 10-12 = cellA (float, Angstroms),
  13-15 = cellB, 16-18 = mapCRS, 19-21 = dmin/dmax/dmean,
  22 = ispg, 23 = nsymbt, 24-48 = extra (word 38 imodStamp,
  word 39 imodFlags), 49-51 = origin.
* Voxel modes: 0 (byte, signed or unsigned), 1 (int16), 2 (float32),
  6 (uint16).  Internally everything is float32.
* Signed-byte detection: default signed; a ``.rec`` filename implies
  unsigned (``mrc_simple.cpp:186-192``); an IMOD stamp
  (``imodStamp == 1146047817``) overrides via bit 0 of imodFlags
  (``mrc_header.cpp:49-77``).
* Non-row-major files (mapCRS != (1,2,3)) are permuted to row-major on
  read, with nvoxels/mvoxels/origin/cellA permuted to match
  (``mrc_simple.cpp:104-174``).
* Writing always emits mode 2 (float32) with refreshed dmin/dmax/dmean,
  like ``MrcSimple::Write`` (``mrc_simple.cpp:362-377``).
* No endian conversion is attempted by the reference; we pin
  little-endian explicitly (the only layout it can actually read on
  commodity hardware).

Data arrays are numpy (Z, Y, X) float32 on the host; move them to a
device with ``torch.as_tensor(data, device=...)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io as _io
import os
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

IMOD_STAMP = 1146047817

MODE_BYTE = 0
MODE_SHORT = 1
MODE_FLOAT = 2
MODE_USHORT = 6

_HEADER_SIZE = 1024
_N_USED_WORDS = 52


class MrcError(Exception):
    """Raised on malformed or unsupported MRC files."""


@dataclasses.dataclass
class MrcHeader:
    """Parsed MRC header. Axis order of tuple fields is (X, Y, Z), the
    same order the words appear in the file."""

    nvoxels: Tuple[int, int, int] = (0, 0, 0)
    mode: int = MODE_FLOAT
    nstart: Tuple[int, int, int] = (0, 0, 0)
    mvoxels: Tuple[int, int, int] = (0, 0, 0)
    cellA: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cellB: Tuple[float, float, float] = (90.0, 90.0, 90.0)
    mapCRS: Tuple[int, int, int] = (1, 2, 3)
    dmin: float = 0.0
    dmax: float = -1.0
    dmean: float = 0.0
    ispg: int = 0
    nsymbt: int = 0
    extra_raw: bytes = b"\0" * 100
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    remaining_raw: bytes = b"\0" * (_HEADER_SIZE - _N_USED_WORDS * 4)
    use_signed_bytes: bool = True

    @property
    def voxel_width_xyz(self) -> Tuple[float, float, float]:
        """Physical voxel width per axis = cellA / nvoxels
        (``mrc_header.hpp:52-57``). 0 when the header has no cell info."""
        return tuple(
            (c / n if n else 0.0) for c, n in zip(self.cellA, self.nvoxels)
        )

    def print_stats(self, out) -> None:
        """Same text layout as ``MrcHeader::PrintStats`` (C++ default
        ostream float formatting = 6 significant digits)."""
        def g(v):
            return f"{float(v):.6g}"

        n = self.nvoxels
        w = self.voxel_width_xyz
        out.write(
            "  mrc file stats:\n"
            f"    number of voxels: {n[0]} x {n[1]} x {n[2]}\n"
            f"    voxel size in file header: {g(w[0])} x {g(w[1])} x {g(w[2])}\n"
            f"    table axis order: {self.mapCRS[0]} {self.mapCRS[1]} {self.mapCRS[2]}\n"
            f"    mode: {self.mode}\n"
            f"    minimum brightness: {g(self.dmin)}\n"
            f"    maximum brightness: {g(self.dmax)}\n"
            f"    mean brightness: {g(self.dmean)}\n"
            f"    origin: {g(self.origin[0])} {g(self.origin[1])} {g(self.origin[2])}\n"
        )


def _read_header(raw: bytes, use_signed_bytes_default: bool) -> MrcHeader:
    if len(raw) < _HEADER_SIZE:
        raise MrcError("MRC file too short: missing 1024-byte header")
    ints = np.frombuffer(raw[: _N_USED_WORDS * 4], dtype="<i4")
    flts = np.frombuffer(raw[: _N_USED_WORDS * 4], dtype="<f4")
    h = MrcHeader(
        nvoxels=(int(ints[0]), int(ints[1]), int(ints[2])),
        mode=int(ints[3]),
        nstart=(int(ints[4]), int(ints[5]), int(ints[6])),
        mvoxels=(int(ints[7]), int(ints[8]), int(ints[9])),
        cellA=(float(flts[10]), float(flts[11]), float(flts[12])),
        cellB=(float(flts[13]), float(flts[14]), float(flts[15])),
        mapCRS=(int(ints[16]), int(ints[17]), int(ints[18])),
        dmin=float(flts[19]),
        dmax=float(flts[20]),
        dmean=float(flts[21]),
        ispg=int(ints[22]),
        nsymbt=int(ints[23]),
        extra_raw=raw[24 * 4 : 49 * 4],
        origin=(float(flts[49]), float(flts[50]), float(flts[51])),
        remaining_raw=raw[_N_USED_WORDS * 4 : _HEADER_SIZE],
        use_signed_bytes=use_signed_bytes_default,
    )
    if h.mode == MODE_BYTE and int(ints[38]) == IMOD_STAMP:
        h.use_signed_bytes = bool(int(ints[39]) & 1)
    return h


def _write_header(h: MrcHeader) -> bytes:
    words = np.zeros(_N_USED_WORDS, dtype="<i4")
    fwords = words.view("<f4")
    words[0:3] = h.nvoxels
    words[3] = h.mode
    words[4:7] = h.nstart
    words[7:10] = h.mvoxels
    fwords[10:13] = h.cellA
    fwords[13:16] = h.cellB
    words[16:19] = h.mapCRS
    fwords[19] = h.dmin
    fwords[20] = h.dmax
    fwords[21] = h.dmean
    words[22] = h.ispg
    words[23] = h.nsymbt
    extra = h.extra_raw.ljust(25 * 4, b"\0")[: 25 * 4]
    words[24:49] = np.frombuffer(extra, dtype="<i4")
    fwords[49:52] = h.origin
    remaining = h.remaining_raw.ljust(
        _HEADER_SIZE - _N_USED_WORDS * 4, b"\0"
    )[: _HEADER_SIZE - _N_USED_WORDS * 4]
    return words.tobytes() + remaining


_MODE_DTYPES = {
    MODE_SHORT: "<i2",
    MODE_FLOAT: "<f4",
    MODE_USHORT: "<u2",
}


@dataclasses.dataclass
class MrcImage:
    """A tomogram: header + (Z, Y, X) float32 voxel data."""

    header: MrcHeader
    data: np.ndarray  # (Z, Y, X) float32

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        return self.data.shape

    @property
    def voxel_width_xyz(self) -> Tuple[float, float, float]:
        return self.header.voxel_width_xyz

    def find_min_max_mean(self, mask: Optional[np.ndarray] = None) -> None:
        """Refresh dmin/dmax/dmean like ``MrcSimple::FindMinMaxMean``;
        voxels where mask == 0 are excluded."""
        d = self.data if mask is None else self.data[mask != 0]
        if d.size == 0:
            self.header.dmin, self.header.dmax, self.header.dmean = 0.0, -1.0, 0.0
            return
        self.header.dmin = float(d.min())
        self.header.dmax = float(d.max())
        self.header.dmean = float(np.asarray(d, dtype=np.float64).mean())

    def rescale01(
        self,
        mask: Optional[np.ndarray] = None,
        out_a: float = 0.0,
        out_b: float = 1.0,
    ) -> None:
        """Affine-map intensities so [dmin, dmax] (computed over the
        mask) becomes [out_a, out_b] (``mrc_simple.cpp:426-445``). All
        voxels are rescaled, even masked-out ones."""
        self.find_min_max_mean(mask)
        dmin, dmax = self.header.dmin, self.header.dmax
        self.data = out_a + (out_b - out_a) * (self.data - dmin) / (dmax - dmin)
        self.find_min_max_mean(None)

    def invert(self, mask: Optional[np.ndarray] = None) -> None:
        """brightness -> 2*mean - brightness over the mask
        (``mrc_simple.cpp:449-484``); masked-out voxels untouched."""
        sel = slice(None) if mask is None else (mask != 0)
        ave = float(np.asarray(self.data[sel], dtype=np.float64).mean())
        self.data[sel] = 2.0 * ave - self.data[sel]
        self.header.dmean = ave
        self.header.dmin = float(min(ave, self.data[sel].min()))
        self.header.dmax = float(max(ave, self.data[sel].max()))

    def write(self, f: Union[str, os.PathLike, BinaryIO]) -> None:
        write_mrc(f, self.data, header=self.header)


def read_mrc(
    f: Union[str, os.PathLike, BinaryIO],
    rescale: bool = False,
    mask: Optional[np.ndarray] = None,
) -> MrcImage:
    """Read an MRC/REC file into an ``MrcImage``.

    ``rescale=True`` maps intensities to [0, 1] like
    ``MrcSimple::Read(..., rescale=true)``.
    """
    signed_default = True
    if isinstance(f, (str, os.PathLike)):
        name = os.fspath(f)
        # .rec files store unsigned bytes (mrc_simple.cpp:186-192)
        if name.endswith(".rec"):
            signed_default = False
        with open(name, "rb") as fh:
            raw = fh.read()
    else:
        raw = f.read()
    header = _read_header(raw, signed_default)
    body = memoryview(raw)[_HEADER_SIZE + header.nsymbt :]  # not a copy

    nx, ny, nz = header.nvoxels
    n = nx * ny * nz
    if header.mode == MODE_BYTE:
        dt = np.dtype("i1" if header.use_signed_bytes else "u1")
    elif header.mode in _MODE_DTYPES:
        dt = np.dtype(_MODE_DTYPES[header.mode])
    else:
        raise MrcError(f"UNSUPPORTED MODE in MRC file: mode={header.mode}")
    if len(body) < n * dt.itemsize:
        raise MrcError(
            f"MRC file truncated: need {n * dt.itemsize} data bytes, "
            f"have {len(body)}"
        )
    arr = np.frombuffer(body[: n * dt.itemsize], dtype=dt)

    if header.mapCRS != (1, 2, 3):
        # File is column/section-major along some permutation of xyz.
        # The file's fastest index runs along axis mapCRS[0]-1, etc.
        # Reproduce MrcSimple::Read's permutation to row-major
        # (mrc_simple.cpp:104-174): permute header tuples by axis_order
        # then scatter samples into the row-major array.
        axis_order = tuple(c - 1 for c in header.mapCRS)  # file idx -> xyz axis
        nvox_file = header.nvoxels  # as stored: counts per file index
        # after permutation header tuples are indexed by xyz axis:
        # field[d] = file_field[k] where file index k maps to axis d
        inv = tuple(axis_order.index(d) for d in range(3))
        header.nvoxels = tuple(nvox_file[inv[d]] for d in range(3))
        header.mvoxels = tuple(header.mvoxels[inv[d]] for d in range(3))
        header.origin = tuple(header.origin[inv[d]] for d in range(3))
        header.cellA = tuple(header.cellA[inv[d]] for d in range(3))
        header.mapCRS = (1, 2, 3)
        # File sample order: slowest = file index 2, fastest = file index 0.
        # File index k counts along xyz axis axis_order[k].
        arr = arr.reshape(
            nvox_file[2], nvox_file[1], nvox_file[0]
        )  # (file k, file j, file i)
        # current array axes (0,1,2) = xyz axes
        # (axis_order[2], axis_order[1], axis_order[0]); want (z, y, x)
        cur = (axis_order[2], axis_order[1], axis_order[0])
        arr = np.transpose(arr, axes=tuple(cur.index(a) for a in (2, 1, 0)))
        nx, ny, nz = header.nvoxels
    else:
        arr = arr.reshape(nz, ny, nx)

    img = MrcImage(header=header, data=np.ascontiguousarray(arr, dtype=np.float32))
    if rescale:
        img.rescale01(mask)
    return img


def write_mrc(
    f: Union[str, os.PathLike, BinaryIO],
    data: np.ndarray,
    header: Optional[MrcHeader] = None,
    voxel_width: Optional[Union[float, Tuple[float, float, float]]] = None,
    report=None,
) -> None:
    """Write (Z, Y, X) data as a mode-2 (float32) MRC file.

    Like ``MrcSimple::Write`` the header's mode is forced to float and
    dmin/dmax/dmean are recomputed from the data. If ``header`` is None
    a fresh one is synthesized; ``voxel_width`` (physical units per
    voxel) then sets cellA = width * nvoxels.  A ``Report`` gets the
    span "mrc: header statistics" (the float64 copy, min, max, mean).
    """
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 3:
        raise ValueError("data must be a 3-D (Z, Y, X) array")
    nz, ny, nx = data.shape
    h = dataclasses.replace(header) if header is not None else MrcHeader()
    h.nvoxels = (nx, ny, nz)
    h.mvoxels = (nx, ny, nz)
    h.mode = MODE_FLOAT
    h.mapCRS = (1, 2, 3)
    if voxel_width is not None:
        if np.isscalar(voxel_width):
            voxel_width = (voxel_width,) * 3
        h.cellA = tuple(w * n for w, n in zip(voxel_width, (nx, ny, nz)))
    stats = contextlib.nullcontext()
    if report is not None:
        # imported here: the host tools write MRC files without torch
        from visfd_tpu_torch.utils.progress import span
        stats = span("mrc: header statistics", report)
    with stats:
        d64 = np.asarray(data, dtype=np.float64)
        h.dmin = float(data.min()) if data.size else 0.0
        h.dmax = float(data.max()) if data.size else -1.0
        h.dmean = float(d64.mean()) if data.size else 0.0
    h.nsymbt = 0

    # the samples straight from the array's memory, not through copies
    head = _write_header(h)
    body = np.ascontiguousarray(data, dtype="<f4").reshape(-1).view(np.uint8)
    if isinstance(f, (str, os.PathLike)):
        with open(f, "wb") as fh:
            fh.write(head)
            fh.write(body)
    else:
        f.write(head)
        f.write(body)
