"""Kernels written by hand for NVIDIA Hopper, each beside its plain PyTorch
version.

Each kernel package has:
  kernel.py — build, bind and launch of the CUDA source under ``csrc/``
  ops.py    — the public wrapper: the kernel for CUDA tensors, the plain
              version for CPU tensors
  ref.py    — the plain PyTorch version, the oracle the kernel is held to
"""
