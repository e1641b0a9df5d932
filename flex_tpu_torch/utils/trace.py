"""Tracing and stage timing on ``torch.profiler``.

Counterpart of ``flex_tpu.utils.trace``:

- :func:`trace` — a ``torch.profiler.profile`` context (CPU activity, and
  CUDA activity when the card is in use) that exports a Chrome trace into
  ``log_dir``.
- :func:`trace_table` / :func:`trace_summary` — the newest trace under
  ``log_dir`` as measured per-op times, and rolled up into op classes for
  the bench harness's columns.
- :func:`span` — the port's own spans at the boundaries of its work (the
  plan call, the plan build and its stages), aggregated in memory
  (:func:`snapshot`) and, while a profiler runs, on the profiler's clock
  (``record_function``); :func:`annotate` puts the launch and the dense
  product on that clock alone.
"""
from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _profiler

try:  # torch's C++ form of record_function: a tenth of its host cost
    from torch._C._profiler import _RecordFunctionFast as _annotation
except ImportError:
    from torch.autograd.profiler import record_function as _annotation

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
    files = [f for f in glob.glob(os.path.join(log_dir, "**", "*.json"),
                                  recursive=True)
             if os.path.basename(f) != SPANS_FILE]
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
             "rows_kernel", "rows_group_kernel", "rows_reduce_kernel",
             "reduce_partials",
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


# -- the span registry -------------------------------------------------------
#
# Set-up spans (setup_span) record always; per-call spans (span) only while
# a torch.profiler runs (torch's own flag) or after enable(True).  Off, a
# per-call span is that flag check and the shared _OFF object: no
# annotation, no event, no lock, no span object.  On, it costs the traced
# window a few µs of host a call, so only what a metric reads is a span;
# the rest of the per-call path is annotated (annotate).

SPANS_FILE = "spans.json"  # the snapshot the command line writes
DEVICE_EVERY = 64  # a device span times one call in this many of its aggregate
_enabled = False           # enable()
_lock = threading.Lock()   # guards _agg and _pending
_local = threading.local()  # .stack: this thread's open spans
# (path, attrs) -> [count, host s, self s, device s, timed calls]
_agg: dict[tuple, list] = {}
# (aggregate, start event, end event, device) in the order they were issued
_pending: deque = deque()
_free: dict = {}  # device -> timing events to record again
_streams: dict = {}  # (device index, raw CUDA stream) -> its torch Stream


def enable(on: bool = True) -> None:
    """Record per-call spans from now on (``on``), or again only while a
    ``torch.profiler`` runs (not ``on``, the default)."""
    global _enabled
    _enabled = bool(on)


class _Off:
    """The span of the off path: one shared object that does nothing.  Its
    methods are C callables (set below), so entering and leaving it runs
    no Python frame: 0.13–0.34 µs an entry on an H100's host, where plain
    methods read up to 0.59."""
    __slots__ = ()


_OFF = _Off()
_Off.__enter__ = staticmethod(itertools.repeat(_OFF).__next__)  # -> _OFF
_Off.__exit__ = staticmethod("".format)  # -> "": an exception propagates
_Off.begin = staticmethod("".format)


def span(name: str, describe=None, *args):
    """A per-call span: a context manager over one piece of the port's
    work, recorded only while a ``torch.profiler`` runs or after
    ``enable(True)``.  ``describe(*args)`` gives (the CUDA device whose
    time to take, or None; the attrs, a dict of hashable values), called
    only when the span records, so the off path computes nothing.  See
    :func:`setup_span` for what a span records."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name, describe, args)
    return _OFF


def annotate(name: str):
    """``record_function(name)`` (its C++ form) while a ``torch.profiler``
    runs, so the work inside is named on the profiler's clock, and else
    the shared off span; it aggregates nothing."""
    if _profiler._is_profiler_enabled:
        return _annotation(name)
    return _OFF


def setup_span(name: str, **attrs):
    """A set-up span (a plan build and its stages), recorded always.

    A span is aggregated by its path (the names of the spans open around
    it on this thread, outer first, joined by ``/``) and its ``attrs``:
    count, host seconds, self seconds (host seconds less its child spans')
    and, for a span with a CUDA device, device seconds.  While a profiler
    runs, a span also enters ``record_function(name)`` (its C++ form), so
    it lands on the profiler's clock beside the work it launched.  A
    device span times one call in :data:`DEVICE_EVERY` of its aggregate
    (the first, then each that many later), and :func:`snapshot` scales
    their device seconds to the aggregate's count.  A timed call records
    a CUDA event on the device's current stream at its ``begin()``, just
    before its first device work, and another at its exit; the device
    seconds between them include any idle of the device in between, such
    as a wait for the launch on an idle device.  Pairs are resolved as
    later ones come in (``query()``, no synchronise)."""
    return _Span(name, None, (), attrs)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _current_stream(dev):
    """``torch.cuda.current_stream(dev)``, made once per device and raw
    stream (a tenth of its host cost; the default stream is 0 on every
    device)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(index)
    return stream


def _event(dev):
    try:
        return _free[dev].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


def _resolve(wait: bool) -> None:
    """Add the device seconds of finished event pairs, oldest first, but
    the newest, whose work was just issued (all of them, waiting for each,
    when ``wait``); call with ``_lock`` held."""
    while len(_pending) > (0 if wait else 1):
        agg, e0, e1, dev = _pending[0]
        if wait:
            e1.synchronize()
        elif not e1.query():
            return
        _pending.popleft()
        agg[3] += e0.elapsed_time(e1) / 1e3
        agg[4] += 1
        _free.setdefault(dev, []).extend((e0, e1))


class _Span:
    """A recording span (see :func:`span`).  Under a profiler its
    annotation opens first, so that a pause of the host while the span
    sets itself up (a garbage collection) is named by the span."""
    __slots__ = ("name", "attrs", "dev", "key", "parent", "rf", "t0",
                 "child_s", "stream", "ev0")

    def __init__(self, name, describe, args, attrs=None):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _annotation(name)
            self.rf.__enter__()
        device, attrs = describe(*args) if describe is not None \
            else (None, attrs or {})
        self.name, self.attrs = name, tuple(attrs.items())
        self.dev = device if device is not None and device.type == "cuda" \
            else None
        self.stream = self.ev0 = None
        self.child_s = 0.0

    def __enter__(self):
        stack = _stack()
        parent = self.parent = stack[-1] if stack else None
        path = self.name if parent is None \
            else f"{parent.key[0]}/{self.name}"
        key = self.key = (path, self.attrs)
        if self.dev is not None:
            agg = _agg.get(key)
            if agg is not None and agg[0] % DEVICE_EVERY:
                self.dev = None  # not a timed call
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def begin(self) -> None:
        """Mark the start of the span's device work (once; nothing for a
        span without a CUDA device, or on a call that is not timed)."""
        if self.dev is not None and self.ev0 is None:
            self.stream = _current_stream(self.dev)
            self.ev0 = _event(self.dev)
            self.ev0.record(self.stream)

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        ev1 = None
        if self.ev0 is not None:
            ev1 = _event(self.dev)
            ev1.record(self.stream)
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_s += host
        with _lock:
            agg = _agg.get(self.key)
            if agg is None:
                agg = _agg[self.key] = [0, 0.0, 0.0, 0.0, 0]
            agg[0] += 1
            agg[1] += host
            agg[2] += host - self.child_s
            if ev1 is not None:
                _pending.append((agg, self.ev0, ev1, self.dev))
                _resolve(wait=False)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def _key(path: str, attrs: tuple) -> str:
    if not attrs:
        return path
    return f"{path}[{','.join(f'{k}={v}' for k, v in attrs)}]"


def snapshot() -> dict:
    """Every aggregate so far, keyed ``path[attr=value,...]``: ``path``,
    ``name`` (the last of the path), ``attrs``, ``count``, ``host_s``,
    ``self_s``, ``device_s`` (the timed calls' device seconds scaled to
    ``count``) and ``device_calls`` (the timed calls).  Waits for the
    device work of the spans whose events are still pending."""
    with _lock:
        _resolve(wait=True)
        return {_key(path, attrs): {
            "path": path, "name": path.rsplit("/", 1)[-1],
            "attrs": dict(attrs), "count": n, "host_s": host,
            "self_s": self_s,
            "device_s": dev_s * n / timed if timed else 0.0,
            "device_calls": timed}
            for (path, attrs), (n, host, self_s, dev_s, timed)
            in _agg.items()}


def reset() -> None:
    """Forget every aggregate, and the events still pending."""
    with _lock:
        _agg.clear()
        _pending.clear()


def format_span_table(snap: dict) -> str:
    """:func:`snapshot` as a table, one row per span path (its attrs
    summed): count, host ms, self ms and device ms."""
    by_path: dict[str, list] = {}
    for e in snap.values():
        row = by_path.setdefault(e["path"], [0, 0.0, 0.0, 0.0])
        row[0] += e["count"]
        row[1] += e["host_s"]
        row[2] += e["self_s"]
        row[3] += e["device_s"]
    lines = [f"{'span':<48s} {'count':>7s} {'host ms':>10s} {'self ms':>10s}"
             f" {'device ms':>10s}"]
    for path in sorted(by_path):
        n, host, self_s, dev_s = by_path[path]
        lines.append(f"{path[-48:]:<48s} {n:>7d} {host * 1e3:>10.3f} "
                     f"{self_s * 1e3:>10.3f} {dev_s * 1e3:>10.3f}")
    return "\n".join(lines)
