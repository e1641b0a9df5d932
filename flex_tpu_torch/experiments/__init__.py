"""The JAX package's card-side probes (``experiments/``), on the card.

Each module is the counterpart of the script of the same name, with its
functions under the script's names and its sizes as defaults:

- :mod:`.micro_ellreduce` — the multiply-reduce over gathered rows
  (kernel 11, :func:`.micro.ell_reduce`) beside the plain product;
- :mod:`.micro_dma_u16` — the per-row DMA-ring gather (kernel 8,
  :func:`.micro.row_gather_sum`, 16 deep) and exact f32 rows from two
  16-bit planes (``u16x2``, plain);
- :mod:`.micro_tpu` — matmul and stream peaks, gathers, segment sums and
  the ELL einsum (plain), the shared-memory probe (kernel 9) and the
  8-deep ring gather (kernel 8);
- :mod:`.micro_vmem_gather` — rows gathered from a slab held on the chip
  (kernel 10, :func:`.micro.slab_gather`, through L2 or in a cluster's
  shared memory).

The hand kernels and their plain versions are in :mod:`.micro`
(``csrc/micro.cu``).  Every function takes ``device=None`` (the card,
:func:`..sparse.device.resolve_device`) and makes its data on the device
from a seeded ``torch.Generator``, or takes the caller's tensors.  Times
come from ``bench/harness.time_ms``: CUDA events on the card, the host
clock on ``device="cpu"``, which measures the plain versions and no
device.  ``main(device=None)`` runs the script's ``__main__`` sequence,
prints its lines under the card's name and power limit, and returns the
numbers:

    python -m flex_tpu_torch.experiments.micro_tpu
"""
from __future__ import annotations

import contextlib

import torch


def p(s: str) -> None:
    print(s, flush=True)


def banner(dev: torch.device) -> str:
    """The line a probe prints first: the card's name and power limit as
    nvidia-smi gives them (the torch name where it does not answer), or
    the host."""
    if dev.type != "cuda":
        return "device: cpu (plain versions on the host; no device metric)"
    from flex_tpu_torch.utils.device_info import smi_query

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"device: {smi_query(idx) or torch.cuda.get_device_name(idx)}"


@contextlib.contextmanager
def exact_f32():
    """f32 matrix products without TF32 inside the block (the flag as it
    was after it)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
