"""Benchmark harness: prepare, time and check SpMM plans, one
configuration or an ordering × k × method × tile-height sweep, with a CSV.

Counterpart of ``flex_tpu.bench.harness``.  Metric conventions:
GFLOP/s = 2·nnz·k / tElap; tPre = the format build from the
device-resident CSR, ended by a synchronise (the CSR upload is timed
apart, ``t_upload_s``); pre/elap = tPre / tElap; err_frac = fraction of
outputs beyond the per-row ``res_check`` tolerance.  On the card tElap is
the median of per-call CUDA-event times after a warmup, and the serial
chain (``t_chain_us``) is timed with CUDA events too; a call under
0.1 ms is timed on the card alone by :func:`time_device_ms` (many calls
in one CUDA graph).  On
``device="cpu"``, asked for explicitly, both use the host clock; the
harness never falls back to the CPU on its own.

The byte-model columns divide by the card's published memory rate
(:data:`..utils.device_info.PEAKS`), and a traced call
(:mod:`..utils.trace`) gives measured time per op class.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from flex_tpu_torch.ops import prepare_fn
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, resolve_device
from flex_tpu_torch.utils.check import CheckResult, res_check

# methods whose prepare reads a CSR uploaded once by the harness
_DEV_METHODS = ("ell", "band", "windowed", "gespmm", "bcoo")


@dataclasses.dataclass
class BenchResult:
    graph: str
    order: str
    method: str
    k: int
    m: int
    nnz: int
    t_pre: float            # seconds
    t_elap: float           # seconds
    gflops: float           # 2·nnz·k / tElap
    pre_ratio: float        # tPre / tElap
    check: CheckResult | None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def row(self) -> dict:
        d = {
            "graph": self.graph, "order": self.order, "method": self.method,
            "k": self.k, "m": self.m, "nnz": self.nnz,
            "t_pre_s": round(self.t_pre, 6), "t_elap_ms": round(self.t_elap * 1e3, 4),
            "gflops": round(self.gflops, 2), "pre_ratio": round(self.pre_ratio, 3),
            "err_frac": self.check.err_frac if self.check else None,
            "max_err": self.check.max_err if self.check else None,
        }
        d.update(self.extra)
        return d


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def time_device_ms(fn: Callable, *args, n: int = 200, reps: int = 5,
                   warmup: int = 3) -> float:
    """Device milliseconds of one ``fn(*args)`` on the card, for calls too
    short for :func:`time_cuda_ms`, whose events around each call measure
    the host's path to the launch: ``n`` calls, after ``warmup``, captured
    into one CUDA graph, the graph replayed ``reps`` times between CUDA
    events, the median replay over ``n``.  The graph takes the host out;
    what is left is the card's time a call, the gap between launches
    included.  The calls must be capturable (no synchronise, no host copy)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn(*args)
    graph.replay()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev])) / n


def time_host_ms(fn: Callable, *args, iters: int = 10, warmup: int = 3
                 ) -> float:
    """Median host-clock milliseconds of ``fn(*args)``, for CPU tensors."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def time_ms(device: torch.device, fn: Callable, *args, iters: int = 10,
            warmup: int = 3) -> float:
    """:func:`time_cuda_ms` on the card, :func:`time_host_ms` on the CPU."""
    timer = time_cuda_ms if device.type == "cuda" else time_host_ms
    return timer(fn, *args, iters=iters, warmup=warmup)


def _chain_time(plan, m: int, n: int, k: int, device: torch.device,
                lo: int = 4, hi: int = 24) -> float:
    """Seconds per call of a serial chain: call i + 1 takes call i's output
    (scaled, cut or zero-padded to n rows) as its B, so no call can start
    before the previous one ends.  The chain is timed at two lengths with
    CUDA events (the host clock on the CPU) and the difference divided by
    the difference in calls; a short signal (under 20 ms) is stretched, up
    to 2048 calls."""
    B0 = torch.zeros((n, k), dtype=torch.float32, device=device)

    def run(steps):
        y = B0
        for _ in range(steps):
            out = plan(y) * 0.01
            y = out[:n] if m >= n else torch.nn.functional.pad(
                out, (0, 0, 0, n - m))
        return y

    def timed(steps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(steps)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        t0 = time.perf_counter()
        run(steps)
        return time.perf_counter() - t0

    def delta(lo_, hi_):
        run(lo_)  # warm
        _sync(device)
        for _ in range(3):
            t_lo, t_hi = timed(lo_), timed(hi_)
            if t_hi > t_lo:
                return (t_hi - t_lo) / (hi_ - lo_)
        return float("nan")

    t = delta(lo, hi)
    if t == t and t * (hi - lo) < 0.020:
        hi2 = lo + min(2048, max(hi - lo, int(0.020 / max(t, 1e-7))))
        t2 = delta(lo, hi2)
        if t2 == t2:
            return t2
    return t


def _card_peaks(device: torch.device) -> dict | None:
    if device.type != "cuda":
        return None
    from flex_tpu_torch.utils.device_info import peaks_for

    return peaks_for(torch.cuda.get_device_name(device))


def check_eps_scale(plan) -> float:
    """``res_check``'s eps_scale for a plan's result: 4, times bf16 eps /
    f32 eps (2^16) when the plan gathers B in bf16, whose ~2^-8 relative
    error a term the f32 tolerance would always flag (as the JAX
    harness scales it)."""
    scale = 4.0
    if getattr(plan, "b_dtype", "float32") == "bfloat16":
        scale *= float(torch.finfo(torch.bfloat16).eps
                       / torch.finfo(torch.float32).eps)
    return scale


def bench_spmm(
    g: CSRGraph,
    k: int,
    method: str = "xla",
    prepare: Callable[..., Any] | None = None,
    B: np.ndarray | None = None,
    gold: np.ndarray | None = None,
    check: bool = True,
    iters: int = 10,
    trace_dir: str | None = None,
    trace: bool | None = None,
    chain: bool | None = None,
    device=None,
    **prep_kwargs,
) -> BenchResult:
    """Prepare ``method``'s plan for ``g`` (``prepare`` in place of the
    method's own prepare function when given), time it at width ``k``,
    and check it against SciPy.  Runs on ``device``: CUDA unless the
    caller names another, or the device of a ``dev=`` CSR.  ``chain``
    (default: below 5 M nonzeros, not for ``"xla"``) adds the serial-chain
    columns; ``trace`` (default: when ``trace_dir`` is given) traces one
    call outside the timed ones."""
    from flex_tpu_torch.io.csv_loader import make_features

    if B is None:
        B = make_features(g, k)
    if prepare is None:
        prepare = prepare_fn(method)
    dev = prep_kwargs.get("dev")
    device = dev.device if dev is not None else resolve_device(device)

    extra: dict[str, Any] = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type)}
    if method in _DEV_METHODS and dev is None:
        # the CSR upload is the loader's job, not the format build's
        t0 = time.perf_counter()
        prep_kwargs["dev"] = DeviceCSR.from_graph(g, device)
        _sync(device)
        extra["t_upload_s"] = round(time.perf_counter() - t0, 3)
    elif dev is None:
        prep_kwargs["device"] = device

    _sync(device)
    t0 = time.perf_counter()
    plan = prepare(g, **prep_kwargs)
    _sync(device)
    t_pre = time.perf_counter() - t0

    B_dev = torch.from_numpy(np.ascontiguousarray(B, np.float32)).to(device)
    t_elap = time_ms(device, plan, B_dev, iters=iters) * 1e-3

    if chain is None:
        chain = g.nnz < 5_000_000 and method != "xla"
    if chain:
        try:
            t_ch = _chain_time(plan, g.m, g.n, k, device)
            if t_ch == t_ch:  # not NaN
                extra["t_chain_us"] = round(t_ch * 1e6, 1)
                extra["gflops_chain"] = round(
                    2 * g.nnz * k / t_ch / 1e9, 1)
        except (RuntimeError, ValueError) as e:  # annotate, keep the row
            extra["chain_error"] = str(e)[:120]

    # the format's statistics become columns
    if hasattr(plan, "stats"):
        for key, val in plan.stats.items():
            if isinstance(val, (int, float, str)):
                extra[f"fmt_{key}"] = val

    # the byte model: predicted traffic, the arithmetic intensity it
    # implies, the share of the card's memory rate that tElap reaches, and
    # the reuse of B rows u = nnz / gathered rows
    peaks = _card_peaks(device)
    if hasattr(plan, "traffic_model"):
        mdl = plan.traffic_model(k)
        extra["model_gb"] = round(mdl["bytes"] / 1e9, 4)
        extra["ai_model"] = round(2 * g.nnz * k / max(mdl["bytes"], 1), 4)
        if peaks is not None:
            extra["hbm_frac"] = round(
                mdl["bytes"] / max(t_elap, 1e-12) / peaks["bytes"], 4)
        if mdl.get("gathered_rows"):
            extra["b_reuse"] = round(g.nnz / mdl["gathered_rows"], 4)

    if trace is None:
        trace = trace_dir is not None
    if trace:
        _trace_columns(plan, B_dev, device, trace_dir, peaks, extra)

    chk = None
    if check:
        from flex_tpu_torch.ops.ref import spmm_scipy

        if gold is None:
            gold = spmm_scipy(g, B)
        chk = res_check(gold, plan(B_dev).cpu().numpy(), g.degrees,
                        eps_scale=check_eps_scale(plan))

    return BenchResult(
        graph=g.name, order=g.order, method=method, k=k, m=g.m, nnz=g.nnz,
        t_pre=t_pre, t_elap=t_elap,
        gflops=2 * g.nnz * k / t_elap / 1e9,
        pre_ratio=t_pre / t_elap if t_elap else float("inf"),
        check=chk,
        extra=extra,
    )


def _trace_columns(plan, B_dev, device, trace_dir, peaks, extra) -> None:
    """One traced call (outside the timed ones), parsed into the measured
    time per op class.  On the card the columns are ``trace_device_ms``
    and ``trace_{gather,scatter,dot}_ms``; on the CPU ``trace_cpu_ms`` and
    ``trace_cpu_{...}_ms``.  A failure to trace or parse only annotates."""
    import shutil
    import tempfile

    from flex_tpu_torch.utils.trace import trace as trace_ctx
    from flex_tpu_torch.utils.trace import trace_summary

    td = trace_dir or tempfile.mkdtemp(prefix="flex_trace_")
    cuda = device.type == "cuda"
    pre = "trace" if cuda else "trace_cpu"
    try:
        with trace_ctx(td, device=device):
            plan(B_dev)
        if trace_dir:
            extra["trace_dir"] = trace_dir
        ts = trace_summary(td)
        if ts["top_ops"]:
            extra[f"{pre}_device_ms" if cuda else f"{pre}_ms"] = \
                ts["device_total_ms"]
            cls = ts.get("class_ms", {})
            for c in ("gather", "scatter", "dot"):
                if cls.get(c):
                    extra[f"{pre}_{c}_ms"] = cls[c]
            if "model_gb" in extra and peaks is not None:
                model_ms = extra["model_gb"] / peaks["bytes"] * 1e12
                extra["trace_vs_model"] = round(
                    ts["device_total_ms"] / max(model_ms, 1e-9), 3)
    except (RuntimeError, OSError, ValueError, KeyError) as e:
        extra["trace_parse_error"] = str(e)[:120]
    finally:
        if not trace_dir:
            shutil.rmtree(td, ignore_errors=True)


# methods whose format has a row-panel height knob
_TM_METHODS = ("panel", "band", "windowed")


def sweep(
    g: CSRGraph,
    ks: tuple[int, ...] = (32, 128),
    orders: tuple[str, ...] = ("ovo", "deg", "rcm", "rabbit"),
    methods: tuple[str, ...] = ("xla",),
    tms: tuple[int, ...] = (128, 256),
    csv_path: str | None = None,
    check: bool = True,
    iters: int = 10,
    trace: bool = True,
    device=None,
) -> list[BenchResult]:
    """Ordering × k × method × tile-height sweep.  Methods without a
    tile-height knob run once per (order, k); a configuration that fails
    (a format that refuses the graph, or any other error) becomes a row
    with an ``error`` column, and the sweep goes on.  ``trace=False``
    skips the traced call per configuration."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.ops import ref as _ref
    from flex_tpu_torch.reorder import reorder

    device = resolve_device(device)
    results = []
    for order in orders:
        g_ord = reorder(g, order, check=False) if order != "ovo" else g
        for k in ks:
            if check:  # one SciPy gold per (ordering, k)
                B = make_features(g_ord, k)
                gold = _ref.spmm_scipy(g_ord, B)
            for method in methods:
                for tm in (tms if method in _TM_METHODS else (None,)):
                    kw = {"tm": tm} if tm is not None else {}
                    if check:
                        kw["B"] = B
                        kw["gold"] = gold
                    try:
                        r = bench_spmm(g_ord, k, method=method, check=check,
                                       iters=iters, trace=trace,
                                       device=device, **kw)
                    except Exception as e:  # record the failure, go on
                        r = BenchResult(
                            graph=g.name, order=order, method=method, k=k,
                            m=g.m, nnz=g.nnz, t_pre=0.0, t_elap=float("inf"),
                            gflops=0.0, pre_ratio=0.0, check=None,
                            extra={"error": f"{type(e).__name__}: {e}"[:200]},
                        )
                    if tm is not None:
                        r.extra["tm"] = tm
                    results.append(r)
                    print(_fmt(r))
    if csv_path:
        write_csv(results, csv_path)
    return results


def _fmt(r: BenchResult) -> str:
    err = f"err={r.check.err_frac:.2e}" if r.check else r.extra.get("error", "")
    chain = ""
    if "gflops_chain" in r.extra:
        chain = (f" chain={r.extra['gflops_chain']:.1f} GF/s"
                 f" ({r.extra['t_chain_us']:.0f}us/call)")
    extra_cols = ""
    if "fmt_pad_ratio" in r.extra:
        extra_cols += f" pad={r.extra['fmt_pad_ratio']:.2f}"
    for key in ("trace_device_ms", "trace_cpu_ms"):
        if key in r.extra:
            extra_cols += f" trace={r.extra[key]:.1f}ms"
    return (
        f"{r.graph:>14s} {r.order:>4s} {r.method:>6s} k={r.k:<4d} "
        f"tPre={r.t_pre*1e3:8.1f}ms tElap={r.t_elap*1e3:8.3f}ms "
        f"{r.gflops:8.1f} GF/s pre/elap={r.pre_ratio:8.2f} "
        f"{err}{chain}{extra_cols}"
    )


def write_csv(results: list[BenchResult], path: str) -> None:
    import csv

    rows = [r.row() for r in results]
    keys: list[str] = []
    for row in rows:
        for key in row:
            if key not in keys:
                keys.append(key)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
