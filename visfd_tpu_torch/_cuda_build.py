"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, at first use; the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``.  The library
is cached under ``visfd_tpu_torch/_build/`` by a hash of the sources
and the flags, so a second process reuses it.
Nothing here runs when the module is imported.

Each C entry point launches on the stream it is given, does not
synchronise, and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.
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

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# sm_90a keeps Hopper-only instructions available to later kernels.  No
# --use_fast_math: IEEE division and sqrt keep the kernels within the
# tolerances the tests hold them to (FMA contraction stays on).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C signature of every entry point: name -> argtypes (all return int).
_SIGNATURES = {
    # in, out, taps (kz | ky | kx), hx, hy, hz, nz, ny, nx, rows, smem,
    # stream
    "visfd_blur3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # in, out, taps (kz | ky | kx), hw, nz, ny, nx, output planes a block,
    # smem, stream
    "visfd_blur3_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # in, out, taps, hw, nz, ny, nx, axis (0: z, 1: y, 2: x), stream
    "visfd_blur_axis": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # in, out, flipped taps (kz, ky, kx; rows padded to a multiple of 4),
    # kx, ky, kz, nz, ny, nx, variant, smem, stages, band, smem_taps,
    # stream
    "visfd_conv3d": [_P, _P, _P] + [_I] * 11 + [_P],
    # blur, out, nz, ny, nx, sigma^2, decreasing, formula, want_v, stream
    "visfd_hessian_principal": [_P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    # block and its plane and row strides; the z halo planes below and
    # above, each with its row stride; the y halo rows before and after,
    # each with its plane stride; out, nz, ny, nx, sigma^2, decreasing,
    # formula, want_v, stream
    "visfd_hessian_principal_block": [_P, _I64, _I, _P, _I, _P, _I, _P, _I64,
                                      _P, _I64, _P, _I, _I, _I, _F, _I, _I,
                                      _I, _P],
    # prev, mid, next, mask (or null), codes, oz, oy, ox, pad, gz0, gy0,
    # nz, ny, stream
    "visfd_blob_extremum": [_P] * 5 + [_I] * 8 + [_P],
    # t6, out, nvox, decreasing, formula, want_v, stream
    "visfd_sym3_score": [_P, _P, _I64, _I, _I, _I, _P],
    # sal, nvec, mask, taps, meta, out, nz, ny, nx, hw, rows, smem,
    # exponent, curves, want_den, sparse, stream
    "visfd_tv_votes": [_P] * 6 + [_I] * 10 + [_P],
    # the same, the fields (nz+2hw, ny+2hw, nx+2hw) with filled halos
    "visfd_tv_votes_prepadded": [_P] * 6 + [_I] * 10 + [_P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                       "PATH to build the visfd_tpu_torch kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvisfd_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists.
    Raises with nvcc's output when a compile fails.  ptxas's register
    and spill report goes to ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, p in procs:
            text = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
            logs.append(text)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        so.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.visfd_error_string.argtypes = [ctypes.c_int]
    lib.visfd_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().visfd_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
