"""Can a hand kernel beat the plain multiply-reduce over gathered rows?

Counterpart of ``experiments/micro_ellreduce.py``: Bg = B[cols] ([N, w, k]
materialised), partial = (v[:, :, None]·Bg).sum(1), at the residue's
shapes (N = 208,000 chunks of w = 32, k = 128, about 6.7 M padded
nonzeros).  ``xla_reduce`` is the plain product; ``pallas_reduce`` (the
TPU's VPU body) and ``pallas_reduce_mxu`` (its batched dot at HIGHEST)
compute the same function, here both on kernel 11
(:func:`.micro.ell_reduce`, exact f32 FMA: a dot of one output row gives
a tensor core nothing to share).  Each line: ms, GB/s of the script's
byte count ``by`` (Bg, v and out once), the largest difference from the
plain product on the first 256 rows.

    python -m flex_tpu_torch.experiments.micro_ellreduce
"""
from __future__ import annotations

import torch

from flex_tpu_torch.bench.harness import time_ms
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.experiments.micro import ell_reduce, ell_reduce_plain
from flex_tpu_torch.sparse.device import resolve_device

N, w, k = 208_000, 32, 128  # ~6.7M padded residue nnz
CB = 64                     # the TPU kernel's rows a grid step


def make_inputs(N: int = N, w: int = w, k: int = k, seed: int = 0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(v f32 [N, w], Bg f32 [N, w, k]), uniform in [0, 1) on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Bg = torch.rand((N, w, k), generator=gen, device=dev)
    v = torch.rand((N, w), generator=gen, device=dev)
    return v, Bg


def xla_reduce(v: torch.Tensor, Bg: torch.Tensor) -> torch.Tensor:
    return ell_reduce_plain(v, Bg)


def pallas_reduce(v: torch.Tensor, Bg: torch.Tensor) -> torch.Tensor:
    return ell_reduce(v, Bg)


def pallas_reduce_mxu(v: torch.Tensor, Bg: torch.Tensor) -> torch.Tensor:
    """The TPU's batched dot at HIGHEST has :func:`pallas_reduce`'s
    function; in exact f32 it is the same kernel."""
    return ell_reduce(v, Bg)


def main(device=None, N: int = N, w: int = w, k: int = k, seed: int = 0,
         iters: int = 10) -> dict:
    dev = resolve_device(device)
    p(banner(dev))
    v, Bg = make_inputs(N, w, k, seed, dev)
    by = N * w * k * 4 + N * w * 4 + N * k * 4
    ref = xla_reduce(v[:256], Bg[:256])
    out = {"device": banner(dev), "bytes": by}
    for name, f in (("xla", xla_reduce), ("pallas_vpu", pallas_reduce),
                    ("pallas_mxu", pallas_reduce_mxu)):
        got = f(v, Bg)[:256]
        err = float((got - ref).abs().max())
        ms = time_ms(dev, f, v, Bg, iters=iters)
        p(f"{name:>10s}: {ms:6.2f} ms  {by / ms / 1e6:5.0f} GB/s  "
          f"maxerr={err:.2e}")
        out[name] = {"ms": ms, "gbps": by / ms / 1e6, "maxerr": err}
    return out


if __name__ == "__main__":
    main()
