"""Input checks that the kernel wrappers share."""

from __future__ import annotations

import torch

# dtype codes of the kernels in csrc/ that take both dtypes
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_rows(name: str, *tensors: torch.Tensor) -> None:
    """One device, one dtype the kernels take, unit stride on the last
    dim, and every row 16-byte aligned (the kernels load 16 bytes at a
    time)."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: takes float32 or bfloat16, not {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: all inputs on one device in one "
                             f"dtype; got {t.dtype} on {t.device} beside "
                             f"{dtype} on {dev}")
    if dev.type != "cuda":
        return
    for t in tensors:
        item = t.element_size()
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s * item % 16 for s in t.stride()[:-1])):
            raise ValueError(f"{name}: needs unit stride on the last dim "
                             f"and 16-byte aligned rows; got stride "
                             f"{t.stride()} at {t.data_ptr():#x}")


def no_backward(name: str, *tensors) -> None:
    """Refuse a call that autograd would record: the kernels have no
    backward (the JAX package's Pallas kernels have none either), and a
    kernel's output made with ``torch.empty`` carries no ``grad_fn``, so a
    train step through it would drop its gradients without a word.  The
    check runs on both devices, so a CPU test catches any train path that
    reaches a kernel's wrapper."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward, as the JAX package's "
                           f"kernel has none: call it with gradients off "
                           f"(torch.no_grad or torch.inference_mode), or "
                           f"train on the blocks/ref paths")


_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device
    (the kernels' launch plans size their grids from it)."""
    index = torch.device(device).index or 0
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]
