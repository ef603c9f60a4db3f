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
