"""visfd_tpu_torch: the PyTorch + CUDA port of visfd_tpu for one NVIDIA
H100.

The package mirrors ``visfd_tpu``'s tree and module names.  Plain tensor
code is PyTorch; each Pallas kernel of the JAX package is a CUDA C++
kernel under ``csrc/``, built by ``nvcc`` at first use
(``_cuda_build.py``).  Every kernel wrapper runs the kernel for a CUDA
tensor and a plain PyTorch twin of it for a CPU tensor.  The sequential
host floods are C++ under ``native/``, built by ``g++`` at first use.
The package never imports jax.
"""


__all__ = ["VoxelGrid"]


def __getattr__(name):
    # VoxelGrid loads torch: exported lazily, so that the host-only tools
    # (print_mrc_stats, histogram_mrc, ...) start without it
    if name == "VoxelGrid":
        from visfd_tpu_torch.core.grid import VoxelGrid
        return VoxelGrid
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
