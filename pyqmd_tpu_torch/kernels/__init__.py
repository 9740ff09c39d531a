"""Hand-written CUDA kernels and their wrappers.

Each wrapper takes the plain PyTorch version of its module for CPU tensors
and launches its kernel for CUDA tensors, counting launches in the
counter ``kernels.<wrapper>.launches`` of
:mod:`pyqmd_tpu_torch.utils.profiling`. The kernels are built from
``pyqmd_tpu_torch/csrc`` on the first CUDA call
(:mod:`pyqmd_tpu_torch.kernels._build`), never at import.
"""
