"""The program's own spans, for the metrics of source ``program_span``.

The port aggregates its spans in memory (``flex_tpu_torch.utils.trace``):
per span path and attrs a count, host seconds, self seconds and, for the
plan call (``flex.spmm``), device seconds between CUDA events around its
device work on one call in every few, scaled to the count.  The events
count the device's wait for a launch where it is idle, so only a cell
whose device is busy (``train``) reads them.  Per-call spans record only
while a profiler runs, so in a traced run they cover the window; the plan
build's (``flex.build``) record always.  Each reader returns None where
the program records no such span, as a program without the registry
does.
"""
from __future__ import annotations

from spmm_bench.arith import spmm_least_s


def snapshot() -> dict | None:
    """The program's span aggregates, or None without a registry."""
    try:
        from flex_tpu_torch.utils import trace
    except ImportError:
        return None
    snap = getattr(trace, "snapshot", None)
    return snap() if snap is not None else None


def entries(name: str) -> list[dict]:
    """The aggregates of the spans called ``name``, wherever they nest."""
    return [e for e in (snapshot() or {}).values() if e["name"] == name]


def step_spmm_roofline(rec):
    """The plan calls' least time (each call's bytes at the memory's peak
    or operations at the float32 peak, whichever is longer, at the widths
    its span records) over their device seconds, in %."""
    calls = [e for e in entries("flex.spmm") if e["device_s"] > 0]
    if not calls:
        return None
    least = sum(e["count"] * spmm_least_s(e["attrs"]["m"], e["attrs"]["n"],
                                          e["attrs"]["nnz"], e["attrs"]["k"])
                for e in calls)
    return least / sum(e["device_s"] for e in calls) * 100


def spmm_host_us(rec):
    """The mean host microseconds of a plan call: checks, allocation, any
    cast of B and the launch."""
    calls = entries("flex.spmm")
    n = sum(e["count"] for e in calls)
    if not n:
        return None
    return sum(e["host_s"] for e in calls) / n * 1e6


def plan_build_ms(rec):
    """The host milliseconds of the outermost plan builds (no build open
    around them): the run's set-up makes them all.  They are the process's
    first builds, so torch's lazy loading of its CUDA kernels is in them."""
    builds = [e for e in entries("flex.build")
              if "flex.build" not in e["path"].split("/")[:-1]]
    if not builds:
        return None
    return sum(e["host_s"] for e in builds) * 1e3
