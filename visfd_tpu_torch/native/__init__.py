"""The native (C++) host floods and blob-list formatter, built at first
use and loaded with ctypes.

Port of ``visfd_tpu/native/__init__.py``.  The sequential
priority-ordered floods (watershed, LabelConnected, blob NMS) stay on
the host, as in the reference (``segmentation.hpp``, ``connect.hpp``),
and so does the text of the blob lists (``format_rows_g6``, which
``io/coords.write_blob_coords_file`` calls): ``visfd_native.cpp`` is
compiled with the system ``g++ -O3`` into ``visfd_tpu_torch/_build/``
under a name keyed by the hash of the source and the flags, so later
processes reuse it.

There is no fallback: ``load()`` raises when the compiler is missing or
the build or the load fails, naming the compiler's error.  (The pure
Python flood, ``segment.connect._flood_python``, and ``io/coords.fmt_g``
are the twins the tests hold the native code against, never a
substitute on the main path.)  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SRC = _HERE / "visfd_native.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libvisfd_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless one for this source exists; raises
    with the compiler's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("visfd_tpu_torch.native: g++ not found on PATH; "
                           "the floods and the list formatter are built from "
                           f"{SRC.name} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: processes that build at
    # once never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", out]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"visfd_tpu_torch.native: g++ failed (exit "
                               f"{r.returncode}):\n{' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(out, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    pf = ctypes.POINTER(ctypes.c_float)
    pf64 = ctypes.POINTER(ctypes.c_double)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.visfd_watershed_flood.restype = i64
    lib.visfd_watershed_flood.argtypes = [
        pf, pu8, i64, i64, i64,
        pi32, pf, i64, pi32, i64,
        f64, f64, i32, pi64]
    lib.visfd_connect_flood.restype = i64
    lib.visfd_connect_flood.argtypes = [
        pf, pu8, pu8, i64, i64, i64,
        pi32, pf, i64, pi32, i64,
        f64, f64, pf, pf, f64, f64, i32,
        pf, pi64, pi64, pi8]
    lib.visfd_connect_flood_compact.restype = i64
    lib.visfd_connect_flood_compact.argtypes = [
        pi32, pf, pu8, i64, i64, i64,
        pi32, pf, i64, pi32, i64,
        f64, f64, pf, pf, f64, f64, i32,
        pf, pi64, pi64, pi8]
    lib.visfd_nms.restype = i64
    lib.visfd_nms.argtypes = [
        pf64, pf64, pf64, pi64, pi64,
        i64, i64, f64, f64, f64,
        pu8]
    lib.visfd_format_rows_g6.restype = i64
    lib.visfd_format_rows_g6.argtypes = [
        pf64, i64, i64, ctypes.POINTER(ctypes.c_char), i64]
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The bound library (built if needed); raises if it cannot be built
    or loaded."""
    so = build()
    try:
        return _bind(ctypes.CDLL(str(so)))
    except OSError as e:
        raise RuntimeError(f"visfd_tpu_torch.native: cannot load {so}: "
                           f"{e}") from e


def ptr(arr, ctype):
    """C pointer for a C-contiguous numpy array (None -> NULL)."""
    if arr is None:
        return None
    if not arr.flags.c_contiguous:
        raise ValueError("native.ptr needs a C-contiguous array")
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def format_rows_g6(rows, buf) -> int:
    """Write the rows of the (n, k) C-contiguous float64 array ``rows``
    into the uint8 array ``buf`` as text, each value as ``io/coords.fmt_g``
    writes it, a space between values and a newline after each row;
    returns the bytes written.  Raises when ``buf`` cannot hold them."""
    if rows.dtype != np.float64 or rows.ndim != 2:
        raise ValueError("native.format_rows_g6 needs (n, k) float64 rows")
    if buf.dtype != np.uint8:
        raise ValueError("native.format_rows_g6 needs a uint8 buffer")
    n = load().visfd_format_rows_g6(
        ptr(rows, ctypes.c_double), rows.shape[0], rows.shape[1],
        ptr(buf, ctypes.c_char), buf.size)
    if n < 0:
        raise ValueError(f"native.format_rows_g6: {buf.size} bytes cannot "
                         f"hold the text of {rows.shape[0]} rows")
    return n
