"""Two experiments: the per-row gather rate of a ring of row copies, and
exact f32 rows from two 16-bit planes.

Counterpart of ``experiments/micro_dma_u16.py``:

- :func:`m3_final` — per grid step of 1024 indices (an (8, 128) index
  block), the sum of the B rows they name (B f32 [262144, 128], 64
  steps), through a ring of 16 row copies: kernel 8
  (:func:`.micro.row_gather_sum`, one block a step, a 16-deep cp.async
  ring a warp).  Its out row 0 is the last step's sum.
- :func:`u16x2` — B's f32 bits as two 16-bit planes (held as int16: torch's
  uint16 arithmetic is thin), each gathered, the f32 bits rebuilt with
  ``view``: the gather of one plane alone (7.68 M rows), the gathers and
  the reduce over [235,000, 128] column chunks, and whether the rebuilt
  rows equal B's bit for bit.  Plain PyTorch, as the script leaves it to
  XLA.

    python -m flex_tpu_torch.experiments.micro_dma_u16
"""
from __future__ import annotations

import torch

from flex_tpu_torch.bench.harness import time_ms
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.experiments.micro import row_gather_sum
from flex_tpu_torch.sparse.device import resolve_device


def m3_final(B: torch.Tensor | None = None, idx: torch.Tensor | None = None,
             *, m: int = 262144, k: int = 128, rows_per_step: int = 1024,
             n_steps: int = 64, depth: int = 16, seed: int = 0, device=None,
             iters: int = 10) -> dict:
    """Kernel 8 on B f32 [m, k] and idx i32 [8·n_steps, 128] (step s: the
    first ``rows_per_step`` indices of rows 8s .. 8s + 7); made on the
    device when not given.  Returns the per-step sums, ``out_row0`` (the
    script's out row 0: the last step's sum), ms and rates."""
    dev = resolve_device(device) if B is None else B.device
    if B is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        B = torch.rand((m, k), generator=gen, device=dev)
    if idx is None:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        idx = torch.randint(0, B.shape[0], (n_steps * 8, 128), generator=gen,
                            device=dev, dtype=torch.int32)
    steps = idx.reshape(idx.shape[0] // 8, -1)[:, :rows_per_step].contiguous()
    sums = row_gather_sum(B, steps, depth)
    ms = time_ms(dev, row_gather_sum, B, steps, depth, iters=iters)
    total = steps.numel()
    row_bytes = B.shape[1] * 4
    p(f"M3 per-row DMA: {total / ms / 1e3:.1f} M rows/s "
      f"({total * row_bytes / ms / 1e6:.1f} GB/s) [{ms:.4f} ms/{total} "
      f"rows]")
    return {"sums": sums, "out_row0": sums[-1], "ms": ms, "rows": total,
            "m_rows_per_s": total / ms / 1e3,
            "gbps": total * row_bytes / ms / 1e6}


def u16_planes(B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): the high and low 16 bits of each f32 of B, as int16."""
    Bi = B.contiguous().view(torch.int32)
    return (Bi >> 16).to(torch.int16), (Bi & 0xFFFF).to(torch.int16)


def u16_rebuild(gh: torch.Tensor, gl: torch.Tensor) -> torch.Tensor:
    """The f32 whose bits are (hi << 16) | lo."""
    return ((gh.to(torch.int32) << 16) | (gl.to(torch.int32) & 0xFFFF)
            ).view(torch.float32)


def u16_small(c: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor
              ) -> torch.Tensor:
    """The rows c of B, gathered from both planes and rebuilt."""
    c = c.long()
    return u16_rebuild(bh.index_select(0, c), bl.index_select(0, c))


def spmm_u16(c: torch.Tensor, v: torch.Tensor, bh: torch.Tensor,
             bl: torch.Tensor, step: int = 16384) -> torch.Tensor:
    """out[r] = Σ_j v[r, j]·B[c[r, j]] for c i32 [NN, w], v f32 [NN, w],
    from the two planes, ``step`` rows of c at a time."""
    NN, w = c.shape
    k = bh.shape[1]
    out = []
    for s in range(0, NN, step):
        e = min(s + step, NN)
        g32 = u16_small(c[s:e].reshape(-1), bh, bl).view(e - s, w, k)
        out.append((v[s:e, :, None] * g32).sum(dim=1))
    return torch.cat(out, 0)


def u16x2(B: torch.Tensor | None = None, cols: torch.Tensor | None = None,
          v: torch.Tensor | None = None, *, m: int = 232_965, k: int = 128,
          w: int = 128, NN: int = 235_000, take_rows: int = 60_000,
          seed: int = 0, device=None, iters: int = 10) -> dict:
    """The script's ``u16x2`` on B f32 [m, k], cols i32 [NN, w] and v
    (ones) f32 [NN, w], made on the device when not given: the one-plane
    gather of ``cols[:take_rows]``, ``spmm_u16`` timed, and the rebuilt
    rows of ``cols[:2]`` against B's (``max_abs_diff``, ``bits_equal``)."""
    dev = resolve_device(device) if B is None else B.device
    if B is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        B = torch.rand((m, k), generator=gen, device=dev)
    if cols is None:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        cols = torch.randint(0, B.shape[0], (NN, w), generator=gen,
                             device=dev, dtype=torch.int32)
    if v is None:
        v = torch.ones(cols.shape, dtype=torch.float32, device=dev)
    B_hi, B_lo = u16_planes(B)

    idx = cols[:take_rows].reshape(-1).long()
    ms_take = time_ms(dev, torch.index_select, B_hi, 0, idx, iters=iters)
    n_take = idx.numel()
    p(f"take-only u16 {n_take / 1e6:.2f}M rows: {ms_take:.4f} ms "
      f"({n_take / ms_take / 1e3:.0f} M rows/s)")
    out = spmm_u16(cols, v, B_hi, B_lo)
    ms = time_ms(dev, spmm_u16, cols, v, B_hi, B_lo, iters=iters)
    p(f"u16x2 exact take+reduce {cols.numel() / 1e6:.1f}M: {ms:.3f} ms")
    ids = cols[:2].reshape(-1)
    got = u16_small(ids, B_hi, B_lo)
    want = B.index_select(0, ids.long())
    diff = float((got - want).abs().max())
    bits = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
    p(f"u16x2 exact? max abs diff = {diff:.3e}, same bits: {bits}")
    return {"out": out, "rebuilt": got, "take_ms": ms_take,
            "take_m_rows_per_s": n_take / ms_take / 1e3, "spmm_ms": ms,
            "max_abs_diff": diff, "bits_equal": bits}


def main(device=None, **sizes) -> dict:
    """The script's sequence: ``u16x2`` then ``m3_final``.  ``sizes`` maps
    a function's name to keywords for it (smaller shapes, ``iters``)."""
    dev = resolve_device(device)
    p(banner(dev))
    res = {"device": banner(dev)}
    for name, fn in (("u16x2", u16x2), ("m3_final", m3_final)):
        r = fn(device=dev, **sizes.get(name, {}))
        res[name] = {key: val for key, val in r.items()
                     if not torch.is_tensor(val)}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    main()
