"""M7: rows gathered by index from a slab held on the chip.

Counterpart of ``experiments/micro_vmem_gather.py``.  The candidate panel
kernel keeps a packed B slab (U × k) on the chip and needs
C[r] += val · Bp[slot[r]]: a per-row dynamic gather.  The script runs
16 grid steps of 8192 gathered rows each from a 2 MiB slab in VMEM, in
three bodies; here each is kernel 10 (:func:`.micro.slab_gather`), which
writes every step's rows to one [16 · 8192, 128] buffer and returns the
last step's, as the script's output keeps:

- :func:`k_take` — the slab read through L2 (placement ``"l2"``);
- :func:`k_dynslice` — the slab spread over the shared memory of a
  16-block cluster, 256 rows = 128 KB a block, read through distributed
  shared memory (placement ``"cluster"``): one block's 227 KB cannot hold
  the 2 MiB slab that VMEM does;
- :func:`k_onehot` — the one-hot bf16 product's function, bf16(slab)[idx]
  widened to f32, on the cluster placement.

    python -m flex_tpu_torch.experiments.micro_vmem_gather
"""
from __future__ import annotations

import torch

from flex_tpu_torch.bench.harness import time_ms
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.experiments.micro import slab_gather
from flex_tpu_torch.sparse.device import resolve_device

U, K = 4096, 128
RB = 1024          # index block columns
R = 8 * RB         # gathered rows per grid step
STEPS = 16


def _last_step(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The last grid step's rows: a step gathers one (8, RB) index
    block."""
    return rows[-8 * idx.shape[1]:]


def k_take(idx: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    return _last_step(slab_gather(slab, idx, "l2"), idx)


def k_dynslice(idx: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    return _last_step(slab_gather(slab, idx, "cluster"), idx)


def k_onehot(idx: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    return _last_step(slab_gather(slab, idx, "cluster", round_bf16=True),
                      idx)


def run(tag: str, kernel, slab: torch.Tensor | None = None,
        idx: torch.Tensor | None = None, *, seed: int = 0, device=None,
        iters: int = 10) -> dict:
    """``kernel`` on slab f32 [U, K] and idx i32 [STEPS·8, RB] (made on
    the device when not given), timed; returns the last step's rows, ms
    and rates over every step's rows."""
    dev = resolve_device(device) if slab is None else slab.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if slab is None:
        slab = torch.rand((U, K), generator=gen, device=dev)
    if idx is None:
        idx = torch.randint(0, slab.shape[0], (STEPS * 8, RB), generator=gen,
                            device=dev, dtype=torch.int32)
    out = kernel(idx, slab)
    ms = time_ms(dev, kernel, idx, slab, iters=iters)
    rows = idx.numel()
    nbytes = rows * slab.shape[1] * 4
    p(f"{tag}: {ms:.4f} ms for {rows} rows = {rows / ms / 1e3:.1f} M rows/s "
      f"({nbytes / ms / 1e6:.0f} GB/s)")
    return {"out": out, "ms": ms, "rows": rows,
            "m_rows_per_s": rows / ms / 1e3, "gbps": nbytes / ms / 1e6}


BODIES = (("M7a take", k_take), ("M7b dynslice", k_dynslice),
          ("M7c onehot", k_onehot))


def main(device=None, **sizes) -> dict:
    """The script's three bodies in turn; ``sizes`` holds keywords for
    :func:`run` (``slab``, ``idx``, ``iters``)."""
    dev = resolve_device(device)
    p(banner(dev))
    res = {"device": banner(dev)}
    for tag, kernel in BODIES:
        r = run(tag, kernel, device=dev, **sizes)
        res[tag] = {key: val for key, val in r.items()
                    if not torch.is_tensor(val)}
    return res


if __name__ == "__main__":
    main()
