"""Microbenchmarks that size the SpMM kernel design space on the card.

Counterpart of ``experiments/micro_tpu.py``.  What the script leaves to
XLA stays plain PyTorch:

- :func:`m5_peaks` — a 4096² f32 matmul with TF32 allowed (JAX's default
  precision on a GPU), with TF32 off (HIGHEST), in bf16; a 512 MB
  read-and-write stream;
- :func:`m1_xla_spmm` — gather, scale and segment sum (``index_select``,
  ``index_add_``) at Reddit's size (232,965 rows, 23,446,803 nonzeros,
  k = 128);
- :func:`m2_gather_bw` — 7.7 M row gathers, random and sorted;
- :func:`m4_segsum` — a sorted segment sum over 12.0 GB of rows;
- :func:`m_ell_fused` — the ELL einsum over gathered rows (w = 101).

The script's two Pallas kernels are hand kernels here:

- :func:`m6_vmem_probe` — the largest shared-memory scratch a block can
  hold (kernel 9, :func:`.micro.smem_probe`), held to the card's opt-in
  limit (``cudaDevAttrMaxSharedMemoryPerBlockOptin``);
- :func:`m3_row_dma` — the per-row gather through an 8-deep ring
  (``kernel2``; its ``kernel`` is never launched): kernel 8,
  :func:`.micro.row_gather_sum`.

    python -m flex_tpu_torch.experiments.micro_tpu
"""
from __future__ import annotations

import torch

from flex_tpu_torch.bench.harness import time_ms
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.experiments.micro import (
    row_gather_sum, smem_optin, smem_probe,
)
from flex_tpu_torch.sparse.device import resolve_device

SMEM_SIZES_KB = (48, 96, 160, 224, 227, 228)


def m5_peaks(n: int = 4096, stream_len: int = 128 * 1024 * 1024,
             seed: int = 0, device=None, iters: int = 5) -> dict:
    """The three matmuls' TFLOP/s and the stream's GB/s.  TF32 is allowed
    for the first matmul only; the previous setting (off in the port) is
    restored in a ``finally``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((n, n), generator=gen, device=dev)
    flop = 2 * n ** 3
    out = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ms = time_ms(dev, torch.matmul, a, a, iters=iters)
        p(f"M5 f32 {n}² matmul (TF32 allowed): {ms:.3f} ms = "
          f"{flop / ms / 1e9:.1f} TFLOP/s")
        out["f32_tf32"] = {"ms": ms, "tflops": flop / ms / 1e9}
        torch.backends.cuda.matmul.allow_tf32 = False
        ms = time_ms(dev, torch.matmul, a, a, iters=iters)
        p(f"M5 f32/HIGHEST: {ms:.3f} ms = {flop / ms / 1e9:.1f} TFLOP/s")
        out["f32_highest"] = {"ms": ms, "tflops": flop / ms / 1e9}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ab = torch.rand((n, n), generator=gen, device=dev).to(torch.bfloat16)
    ms = time_ms(dev, torch.matmul, ab, ab, iters=iters)
    p(f"M5 bf16: {ms:.3f} ms = {flop / ms / 1e9:.1f} TFLOP/s")
    out["bf16"] = {"ms": ms, "tflops": flop / ms / 1e9}

    x = torch.rand(stream_len, generator=gen, device=dev)
    ms = time_ms(dev, torch.mul, x, 1.0000001, iters=iters)
    nbytes = 2 * x.numel() * 4
    p(f"M0 stream r+w {nbytes / 1e9:.1f}GB: {ms:.3f} ms = "
      f"{nbytes / ms / 1e6:.0f} GB/s")
    out["stream"] = {"ms": ms, "gbps": nbytes / ms / 1e6}
    return out


def _sorted_rows(m: int, nnz: int, gen, dev) -> torch.Tensor:
    return torch.randint(0, m, (nnz,), generator=gen, device=dev).sort()[0]


def xla_spmm(rows, cols, vals, B, m: int) -> torch.Tensor:
    """C = segment_sum(B[cols]·vals, rows): gather, scale in place,
    ``index_add_``."""
    g = B.index_select(0, cols)
    g.mul_(vals[:, None])
    return B.new_zeros((m, B.shape[1])).index_add_(0, rows, g)


def m1_xla_spmm(m: int = 232_965, nnz: int = 23_446_803, k: int = 128,
                seed: int = 0, device=None, iters: int = 3) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = _sorted_rows(m, nnz, gen, dev)
    cols = torch.randint(0, m, (nnz,), generator=gen, device=dev)
    vals = torch.rand(nnz, generator=gen, device=dev)
    B = torch.rand((m, k), generator=gen, device=dev)
    out = xla_spmm(rows, cols, vals, B, m)
    ms = time_ms(dev, xla_spmm, rows, cols, vals, B, m, iters=iters)
    p(f"M1 take+segsum m={m} nnz={nnz} k={k}: {ms:.3f} ms = "
      f"{2 * nnz * k / ms / 1e6:.0f} GFLOP/s eff")
    return {"out": out, "ms": ms, "gflops": 2 * nnz * k / ms / 1e6}


def m2_gather_bw(m: int = 232_965, k: int = 128, nrows: int = 7_700_000,
                 seed: int = 0, device=None, iters: int = 3) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = torch.rand((m, k), generator=gen, device=dev)
    idx = torch.randint(0, m, (nrows,), generator=gen, device=dev)
    gb = nrows * k * 4 / 1e9
    ms = time_ms(dev, torch.index_select, B, 0, idx, iters=iters)
    p(f"M2 take {nrows / 1e6:.1f}M rows ({gb:.1f} GB out): {ms:.3f} ms = "
      f"{gb / ms * 1e3:.0f} GB/s-out ({nrows / ms / 1e3:.0f} M rows/s)")
    ms_s = time_ms(dev, torch.index_select, B, 0, idx.sort()[0],
                   iters=iters)
    p(f"M2s take sorted: {ms_s:.3f} ms = {gb / ms_s * 1e3:.0f} GB/s-out")
    return {"ms": ms, "gbps_out": gb / ms * 1e3,
            "m_rows_per_s": nrows / ms / 1e3, "sorted_ms": ms_s,
            "sorted_gbps_out": gb / ms_s * 1e3}


def segsum(rows, z, m: int) -> torch.Tensor:
    return z.new_zeros((m, z.shape[1])).index_add_(0, rows, z)


def m4_segsum(m: int = 232_965, nnz: int = 23_446_803, k: int = 128,
              seed: int = 0, device=None, iters: int = 3) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = _sorted_rows(m, nnz, gen, dev)
    z = torch.rand((nnz, k), generator=gen, device=dev)
    nbytes = z.numel() * 4
    out = segsum(rows, z, m)
    ms = time_ms(dev, segsum, rows, z, m, iters=iters)
    p(f"M4 sorted segsum ({nbytes / 1e9:.1f} GB in): {ms:.3f} ms = "
      f"{nbytes / ms / 1e6:.0f} GB/s")
    return {"out": out, "ms": ms, "gbps": nbytes / ms / 1e6}


def ell(c, v, b) -> torch.Tensor:
    return torch.einsum("rw,rwk->rk", v, b[c.long()])


def m_ell_fused(m: int = 232_965, k: int = 128, w: int = 101, seed: int = 0,
                device=None, iters: int = 3) -> dict:
    """ELL einsum: the rows gathered ([m, w, k], 12.0 GB at the script's
    size), then the contraction."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.randint(0, m, (m, w), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.rand((m, w), generator=gen, device=dev)
    B = torch.rand((m, k), generator=gen, device=dev)
    out = ell(cols, vals, B)
    ms = time_ms(dev, ell, cols, vals, B, iters=iters)
    nnz = m * w
    p(f"M8 ELL einsum w={w}: {ms:.3f} ms = "
      f"{2 * nnz * k / ms / 1e6:.0f} GFLOP/s eff")
    return {"out": out, "ms": ms, "gflops": 2 * nnz * k / ms / 1e6}


def m6_vmem_probe(sizes_kb=SMEM_SIZES_KB, device=None) -> dict:
    """Kernel 9 at each size in KB, in turn, until the card refuses one.
    On the card every size at or below the opt-in limit must launch and
    the first refusal lie above it, so the largest size that launched is
    the limit's (227 KB = 232,448 B on an H100 with the default sizes);
    anything else raises.  The host has no limit: every size runs."""
    dev = resolve_device(device)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    ok, refused = 0, None
    for kb in sizes_kb:
        try:
            got = smem_probe(x, kb * 1024)
        except RuntimeError as e:
            refused, reason = kb, str(e)
            break
        if not torch.equal(got, x):
            raise AssertionError(f"kernel 9 at {kb} KB did not copy x")
        ok = kb
    limit = smem_optin(dev) if dev.type == "cuda" else None
    if refused is None:
        p(f"M6 smem scratch: >= {ok} KB OK")
    else:
        p(f"M6 smem scratch: {ok} KB OK, {refused} KB FAIL ({reason}); "
          f"the card's opt-in limit a block: {limit} B")
    if limit is not None:
        check_probe_limit(sizes_kb, ok, refused, limit)
    return {"ok_kb": ok, "refused_kb": refused, "limit_bytes": limit}


def check_probe_limit(sizes_kb, ok: int, refused: int | None,
                      limit: int) -> None:
    """The probe found the card's limit: the largest size that launched is
    the largest at or below ``limit`` bytes, and a refused size lies
    above it.  Raises AssertionError otherwise."""
    want = max((kb for kb in sizes_kb if kb * 1024 <= limit), default=0)
    if ok != want or (refused is not None and refused * 1024 <= limit):
        raise AssertionError(
            f"shared-memory probe: {ok} KB launched, {refused} KB refused; "
            f"the card's limit is {limit} B")


def m3_row_dma(B: torch.Tensor | None = None,
               idx: torch.Tensor | None = None, *, rows_per_step: int = 1024,
               n_steps: int = 32, m: int = 262144, k: int = 128,
               depth: int = 8, seed: int = 1, device=None,
               iters: int = 3) -> dict:
    """Kernel 8 with an 8-deep ring on B f32 [m, k] and idx i32 [n_steps,
    rows_per_step], made on the device when not given.  Returns the
    per-step sums (the script's out row 0 is the last), ms and rates."""
    dev = resolve_device(device) if B is None else B.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if B is None:
        B = torch.rand((m, k), generator=gen, device=dev)
    if idx is None:
        idx = torch.randint(0, B.shape[0], (n_steps, rows_per_step),
                            generator=gen, device=dev, dtype=torch.int32)
    sums = row_gather_sum(B, idx, depth)
    ms = time_ms(dev, row_gather_sum, B, idx, depth, iters=iters)
    total = idx.numel()
    row_bytes = B.shape[1] * 4
    p(f"M3 per-row DMA gather: {total / ms / 1e3:.2f} M rows/s "
      f"({total * row_bytes / ms / 1e6:.1f} GB/s) [{ms:.4f} ms/{total} "
      f"rows]")
    return {"sums": sums, "out_row0": sums[-1], "ms": ms, "rows": total,
            "m_rows_per_s": total / ms / 1e3,
            "gbps": total * row_bytes / ms / 1e6}


SEQUENCE = ("m5_peaks", "m6_vmem_probe", "m3_row_dma", "m2_gather_bw",
            "m4_segsum", "m1_xla_spmm", "m_ell_fused")


def main(device=None, **sizes) -> dict:
    """The script's sequence (:data:`SEQUENCE`), one probe after the other,
    the card's cache emptied between them (m4 and m_ell_fused each hold
    12.0 GB).  ``sizes`` maps a function's name to keywords for it."""
    dev = resolve_device(device)
    p(banner(dev))
    res = {"device": banner(dev)}
    for name in SEQUENCE:
        r = globals()[name](device=dev, **sizes.get(name, {}))
        res[name] = {key: val for key, val in r.items()
                     if not torch.is_tensor(val)}
        del r
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    main()
