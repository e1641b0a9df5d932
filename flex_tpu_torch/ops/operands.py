"""Operand checks shared by the kernel wrappers: what a wrapper verifies
before it hands raw pointers to a CUDA kernel; and the checks of the JAX
signatures' ``interpret`` and ``precision`` keywords, which the card has
no use for."""
from __future__ import annotations

import enum

import torch


def check_interpret(interpret) -> None:
    """``interpret`` (the JAX package's Pallas interpret mode) must be a
    bool or None; the port accepts it and ignores it, since the card has no
    interpret mode."""
    if interpret not in (None, True, False):
        raise ValueError(f"interpret must be a bool or None, got "
                         f"{interpret!r}")


def check_precision(precision) -> None:
    """``precision`` (a JAX dot precision: None, a name, a
    ``jax.lax.Precision`` member or a pair of them) must have that type;
    the port accepts it and ignores it, since its products are exact
    f32."""
    pair = precision if isinstance(precision, tuple) else (precision,)
    if len(pair) not in (1, 2) or not all(
            p is None or isinstance(p, (str, enum.Enum)) for p in pair):
        raise TypeError(f"precision must be None, a name, a Precision "
                        f"member or a pair of them, got {precision!r}")


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


def check_kernel_operands(aligned=(), row_strided=(), **tensors) -> None:
    """What the CUDA kernels add to :func:`check_operands`: every tensor
    contiguous and no size beyond the kernels' int32 arguments; those named
    in ``aligned`` start on a 16-byte boundary (they move by float4).  A
    2-D tensor named in ``row_strided`` may instead have rows ``stride(0)
    >= size(1)`` elements apart (``stride(1) == 1``): the layout of a
    column slice of a wider buffer, which the kernel reads by row
    stride."""
    for name, t in tensors.items():
        if not t.is_contiguous() and not (
                name in row_strided and t.dim() == 2 and t.stride(1) == 1
                and t.stride(0) >= t.shape[1]):
            raise ValueError(f"{name} must be contiguous" + (
                " or row-strided (stride(1) == 1, stride(0) >= size(1))"
                if name in row_strided else ""))
        if max(t.shape, default=0) >= 2**31 or (
                name in row_strided and t.dim() == 2 and t.stride(0) >= 2**31):
            raise ValueError(f"a size of {name} exceeds the kernel's int32 "
                             f"arguments")
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
