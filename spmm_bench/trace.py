"""The benchmark's own spans and its reading of the profiler's trace.

Every run records host spans (:class:`Spans`) around the calls it makes
into the port: a name and a duration on the host clock.  A traced run
also wraps each span in ``torch.profiler.record_function`` and runs
``torch.profiler`` (CPU and CUDA activity) over the window, whose own span
is ``bench.window``.  :func:`read_trace` then takes from the profiler's
events, whatever their names:

- every device activity (kernels, copies, fills) inside the window;
- the device's busy seconds, the union of those intervals;
- the device operations that took most time, summed by name;
- the longest idle gaps of the device, each named by the innermost host
  event (a span of the benchmark or an operation of the program) that was
  open halfway through the gap.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

WINDOW_SPAN = "bench.window"
TOP = 10  # entries of each breakdown list


class Spans:
    """Host spans by name: durations in seconds, in the order they ended."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.durations: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            with record_function(f"bench.{name}"):
                t0 = time.perf_counter()
                yield
                self.durations[name].append(time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            yield
            self.durations[name].append(time.perf_counter() - t0)


def _union_s(starts: np.ndarray, ends: np.ndarray) -> float:
    """Seconds covered by the union of intervals given in nanoseconds."""
    if not len(starts):
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # an interval opens a new run where it starts past every earlier end
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    run_start = s[new]
    run_end = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return float((run_end - run_start).sum()) / 1e9


def read_trace(events) -> dict:
    """The traced window's device record from the profiler's raw events
    (``prof.profiler.kineto_results.events()``): ``window_s``,
    ``busy_s``, ``device_ops`` (count of device activities), and the
    ``breakdown`` lists.  Raises if the window's span is missing."""
    win = [ev for ev in events if ev.name() == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    # a host annotation (a benchmark span, or torch's own such as
    # "Optimizer.step#Adam.step") has a copy on the device's timeline under
    # its name; no kernel, copy or fill is named as a host event is
    on_host = {ev.name() for ev in events if ev.device_type().name == "CPU"}
    dev, host = [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if e <= w0 or s >= w1:
            continue
        if ev.device_type().name != "CPU" and ev.name() not in on_host:
            dev.append((ev.name(), max(s, w0), min(e, w1)))
        elif ev.name() != WINDOW_SPAN:
            host.append((ev.name(), s, e))
    starts = np.array([d[1] for d in dev], dtype=np.int64)
    ends = np.array([d[2] for d in dev], dtype=np.int64)
    busy = _union_s(starts, ends)
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy,
            "device_ops": len(dev), "device_s": float((ends - starts).sum())
            / 1e9, "breakdown": {"device_ops": [[n, s] for n, s in ops],
                                 "idle_gaps": _idle_gaps(starts, ends, w0, w1,
                                                         host)}}


def _idle_gaps(starts, ends, w0, w1, host) -> list:
    """The :data:`TOP` longest stretches of the window in which no device
    activity ran, each as [name of the innermost host event open at its
    midpoint ("none" if none was), seconds]."""
    if len(starts):
        order = np.argsort(starts, kind="stable")
        s, e = starts[order], np.maximum.accumulate(ends[order])
        gap_s = np.concatenate([[w0], e])
        gap_e = np.concatenate([s, [w1]])
    else:
        gap_s, gap_e = np.array([w0]), np.array([w1])
    length = gap_e - gap_s
    top = np.argsort(-length, kind="stable")[:TOP]
    hs = np.array([h[1] for h in host], dtype=np.int64)
    he = np.array([h[2] for h in host], dtype=np.int64)
    out = []
    for i in top:
        if length[i] <= 0:
            break
        t = (gap_s[i] + gap_e[i]) // 2
        open_ = np.flatnonzero((hs <= t) & (he > t)) if len(hs) else []
        name = host[open_[np.argmax(hs[open_])]][0] if len(open_) else "none"
        out.append([name, float(length[i]) / 1e9])
    return out


def idle_pct(rec):
    """The device's idle share of the traced window, in %: 1 - (the union
    of device activity intervals / the window); None without a trace."""
    tr = rec.get("trace")
    if not tr:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100
