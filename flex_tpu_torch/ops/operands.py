"""Operand checks shared by the kernel wrappers: what a wrapper verifies
before it hands raw pointers to a CUDA kernel."""
from __future__ import annotations

import torch


def check_operands(ints: dict, floats: dict) -> None:
    """``ints``: name -> (tensor, shape), each int32 of exactly that shape
    (an int stands for a 1-D length); ``floats``: name -> float32 tensor;
    all on one device."""
    for name, (t, shape) in ints.items():
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    devices = {t.device for t, _ in ints.values()} | {
        t.device for t in floats.values()}
    if len(devices) != 1:
        raise ValueError(f"arguments lie on several devices: {devices}")


def check_kernel_operands(aligned=(), **tensors) -> None:
    """What the CUDA kernels add to :func:`check_operands`: every tensor
    contiguous and no size beyond the kernels' int32 arguments; those named
    in ``aligned`` start on a 16-byte boundary (they move by float4)."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if max(t.shape, default=0) >= 2**31:
            raise ValueError(f"a size of {name} exceeds the kernel's int32 "
                             f"arguments")
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
