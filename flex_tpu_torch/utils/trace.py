"""Tracing and stage timing on ``torch.profiler``.

Counterpart of ``flex_tpu.utils.trace``:

- :func:`trace` — a ``torch.profiler.profile`` context (CPU activity, and
  CUDA activity when the card is in use) that exports a Chrome trace into
  ``log_dir``.
- :func:`trace_table` / :func:`trace_summary` — the newest trace under
  ``log_dir`` as measured per-op times, and rolled up into op classes for
  the bench harness's columns.
- :class:`StageTimer` — host-clock stage accounting that synchronises CUDA.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch

# Chrome-trace categories of work that ran on the card.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _uses_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the body; on exit, write ``trace-<ns>.json`` (Chrome trace
    format) into ``log_dir``.  CUDA activity is recorded when ``device`` is
    a CUDA device (or None with a card present), and the body's work is
    synchronised before the profiler stops."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _uses_cuda(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def _newest_trace(log_dir: str) -> str | None:
    files = glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True)
    return max(files, key=os.path.getmtime) if files else None


def trace_table(log_dir: str) -> list[dict]:
    """The newest Chrome trace under ``log_dir`` as measured per-op times:
    ``[{op, count, total_ms, avg_us}, ...]``, by total time descending.

    Events are the card's (``"cat"`` kernel, memcpy or memset) where the
    trace has any; a CPU-only trace falls back to its ``cpu_op`` events,
    whose nested calls each count (attribution, not wall time)."""
    path = _newest_trace(log_dir)
    if path is None:
        return []
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    picked = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if not picked:
        picked = [e for e in events if e.get("cat") == "cpu_op"]
    agg: dict[str, list[float]] = {}
    for e in picked:
        ent = agg.setdefault(e["name"], [0, 0.0])
        ent[0] += 1
        ent[1] += float(e["dur"])  # microseconds
    rows = [
        {"op": op, "count": c, "total_ms": round(us / 1e3, 4),
         "avg_us": round(us / max(c, 1), 2)}
        for op, (c, us) in agg.items()
    ]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


# Op classes of the measured-side join; the first class whose key the
# lower-cased name contains wins.  "dot" holds the hand kernels by their
# device-function names (csrc/), the passes that add their partial tiles
# or split rows, cuBLAS/CUTLASS GEMMs and cuSPARSE products; gathers are
# index_select and advanced indexing; scatters are index_add_ and
# index_copy_ (whose CUDA kernels are indexFunc*) and scatter ops.
_OP_CLASSES = (
    ("dot", ("window_spmm_kernel", "window_spmm_t_kernel",
             "window_bwd_ga_kernel", "window_bwd_gb_kernel", "band_kernel",
             "rows_kernel", "rows_reduce_kernel", "reduce_partials",
             "gemm", "gemv", "xmma", "cutlass", "csrmm", "spmm",
             "aten::mm", "aten::bmm", "aten::addmm", "aten::matmul",
             "aten::_sparse", "dot", "convolution")),
    ("scatter", ("scatter", "index_add", "index_copy", "indexfunc",
                 "index_put", "index_reduce", "segment_reduce")),
    ("gather", ("gather", "index_select", "indexselect", "aten::index",
                "index_elementwise", "take", "embedding")),
    ("copy", ("copy", "memcpy", "transpose", "reshape", "cat", "clone",
              "contiguous")),
)


def classify_op(name: str) -> str:
    low = name.lower()
    for cls, keys in _OP_CLASSES:
        if any(key in low for key in keys):
            return cls
    return "other"


def trace_summary(log_dir: str, top: int = 12) -> dict:
    """:func:`trace_table` rolled up into the harness's columns: total
    measured ms, ms per op class (gather / scatter / dot / copy / other)
    and the top ops."""
    rows = trace_table(log_dir)
    total = sum(r["total_ms"] for r in rows)
    by_class: dict[str, float] = {}
    for r in rows:
        cls = classify_op(r["op"])
        by_class[cls] = by_class.get(cls, 0.0) + r["total_ms"]
    return {
        "device_total_ms": round(total, 3),
        "class_ms": {c: round(v, 3) for c, v in by_class.items()},
        "top_ops": rows[:top],
    }


def format_trace_table(rows: list[dict], top: int = 12) -> str:
    lines = [f"{'op':<48s} {'count':>6s} {'total ms':>10s} {'avg us':>9s}"]
    for r in rows[:top]:
        lines.append(f"{r['op'][:48]:<48s} {r['count']:>6d} "
                     f"{r['total_ms']:>10.3f} {r['avg_us']:>9.2f}")
    return "\n".join(lines)


class StageTimer:
    """Named host-clock stages; a stage whose work runs on the card passes
    its output through :meth:`sync`, which waits for the card."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:  # a raising stage still records its elapsed time
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + time.perf_counter() - t0)

    @staticmethod
    def sync(out):
        """Wait for the card when ``out`` holds a CUDA tensor."""
        leaves = out if isinstance(out, (list, tuple)) else (out,)
        if any(torch.is_tensor(x) and x.is_cuda for x in leaves):
            torch.cuda.synchronize()
        return out

    def report(self) -> str:
        total = sum(self.stages.values()) or 1e-12
        lines = [f"{k:>20s}: {v*1e3:10.2f} ms ({v/total:6.1%})"
                 for k, v in self.stages.items()]
        lines.append(f"{'total':>20s}: {total*1e3:10.2f} ms")
        return "\n".join(lines)
