"""Benchmark harness on the card.

Metric conventions (as in ``flex_tpu.bench.harness``): GFLOP/s =
2·nnz·k / tElap; tPre = format build from the device-resident CSR,
ended by a synchronise; pre/elap = tPre / tElap; err_frac = fraction of
outputs beyond the per-row ``res_check`` tolerance.  tElap is the median
of per-call CUDA-event times after a warmup.  A measurement needs a CUDA
device; there is no CPU fallback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from flex_tpu_torch.ops import prepare_fn
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR
from flex_tpu_torch.utils.check import res_check


@dataclasses.dataclass
class BenchResult:
    graph: str
    order: str
    method: str
    k: int
    m: int
    nnz: int
    t_pre_s: float
    t_elap_ms: float
    gflops: float          # 2·nnz·k / tElap
    pre_elap_ratio: float  # tPre / tElap
    err_frac: float | None
    device: str


def time_cuda_ms(fn: Callable, *args, iters: int = 10, warmup: int = 3
                 ) -> float:
    """Median milliseconds of ``fn(*args)`` over ``iters`` calls, each
    bracketed by CUDA events on the current stream, after ``warmup``
    calls."""
    for _ in range(warmup):
        fn(*args)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def bench_spmm(g: CSRGraph, k: int, method: str = "windowed",
               dev: DeviceCSR | None = None, B: np.ndarray | None = None,
               gold: np.ndarray | None = None, iters: int = 10,
               check: bool = True, **prep_kwargs):
    """Prepare, time and check one plan on the CUDA device.  Returns
    (BenchResult, plan)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_spmm measures on a CUDA device; none found")
    from flex_tpu_torch.io.csv_loader import make_features

    if dev is None:
        dev = DeviceCSR.from_graph(g, "cuda")
    if B is None:
        B = make_features(g, k)
    prepare = prepare_fn(method)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = prepare(g, dev=dev, **prep_kwargs)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0

    B_dev = torch.from_numpy(np.ascontiguousarray(B, np.float32)).to(dev.device)
    t_elap_ms = time_cuda_ms(plan, B_dev, iters=iters)
    err = None
    if check:
        from flex_tpu_torch.ops.ref import spmm_scipy

        if gold is None:
            gold = spmm_scipy(g, B)
        err = res_check(gold, plan(B_dev).cpu().numpy(), g.degrees).err_frac
    r = BenchResult(
        graph=g.name, order=g.order, method=method, k=k, m=g.m, nnz=g.nnz,
        t_pre_s=t_pre, t_elap_ms=t_elap_ms,
        gflops=2 * g.nnz * k / (t_elap_ms * 1e-3) / 1e9,
        pre_elap_ratio=t_pre / (t_elap_ms * 1e-3),
        err_frac=err, device=torch.cuda.get_device_name(dev.device),
    )
    return r, plan
