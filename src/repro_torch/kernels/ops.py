"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``): the wrappers themselves, re-exported.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
on CPU tensors.  Unlike the reference there is no backend switch and no
environment variable that selects one: on the card it would quietly swap
the kernel for the plain version.
"""

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.nested_matmul import nested_matmul
from repro_torch.kernels.rwkv_scan import rwkv_scan

__all__ = ["decode_attention", "flash_attention", "nested_matmul",
           "rwkv_scan"]
