"""One run of one cell, driven by ``BENCHMARK.json`` and the files it
names: the configuration file, the traffic file
(``traffic/<traffic>.json``), the traffic's kind (``kinds/<kind>.py``),
the configuration's model (``models/<model kind>.py``) and its plain
reference (``reference/<model kind>.py``), the cell's limits
(``limits/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``, a ``read(rec)`` that returns a number, or None
where it finds nothing to read).  Adding a configuration, a model, a
traffic mix or kind, a cell or a metric adds files and entries; no file
here changes.

A kind's window returns a record whose ``counts`` names what its
``count`` counts: ``train_steps``, ``requests`` (with their
``latencies``) or ``spmm_calls``.  The end-to-end readers
(``train_step_ms``, ``infer_p95_ms``, ``spmm_gflops``) key on that, so
a new kind whose window counts one of these reports that metric in any
cell listed under it.  The per-layer readers that count a whole-graph
model's work per counted unit (``spmm_mfu``, ``spmm_roofline``,
``kernels_per_request`` and the ``*_mfu`` of the models) key on the
kind's name instead, since a unit of another kind (a sampled step) is
not that work; a new kind brings per-layer readers of its own.  Every
cell reports one of the end-to-end metrics the benchmark has: a record
with no ``counts``, or an untraced run that lacks an end-to-end metric
its cell is listed under, raises, and no result is printed.

A run: set-up (the cell's graph, ordering and plan, the seed's inputs,
the warm-up), the window (traced with ``torch.profiler`` under
``--trace 1``), the peak memory read, the program's state released, then
the comparison with the plain reference.  :func:`run` returns the result
line and the compared numbers beside their limits.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import time

import torch

from spmm_bench import graphs, workload
from spmm_bench.trace import Spans, read_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "flex_tpu")


class Bench:
    """``BENCHMARK.json`` at ``root`` and the benchmark's folder
    (``paths[0]``) that holds the files it names."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.dir = os.path.join(root, self.spec["paths"][0])

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for wl in self.spec["workloads"]:
            if wl["name"] == name:
                return wl
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (``--trace 0``) or per-layer ones
        (``--trace 1``): those that list the cell, or list no cells and
        move (per-layer) or are (end-to-end) a metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ())
                or "workloads" not in m and m["moves"] in names]

    def reader(self, name: str):
        return workload.load(self.dir, "metrics", name, "metric").read

    def cell(self, cell_name: str, device, log,
             cache_dir: str = graphs.CACHE_DIR) -> workload.Cell:
        """The cell's :class:`workload.Cell` on ``device``."""
        wl = self.workload(cell_name)
        return workload.Cell(self.config(wl["config"]),
                             self.traffic(wl["traffic"]), device, log,
                             cache_dir, self.dir)


def card_info(device) -> dict:
    """The contract's ``device`` entry (without the peak), and the card's
    power limit where nvidia-smi answers."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1}
    idx = dev.index or 0
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(idx),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip()
        out["power_limit_w"] = float(smi.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return out


def kernel_builds(since: float) -> str:
    """Where the port's compiled libraries came from: how many of those in
    its build directory were there before ``since`` (wall clock) and how
    many were built after."""
    from flex_tpu_torch.kernels import BUILD_DIR

    libs = glob.glob(os.path.join(BUILD_DIR, "*.so"))
    new = sum(os.path.getmtime(p) >= since for p in libs)
    return f"{len(libs) - new} read from {BUILD_DIR}, {new} built in this run"


def forbidden_modules(modules) -> list[str]:
    """Loaded top-level names, compared whole, of JAX or its package."""
    return sorted({n.split(".")[0] for n in modules} & set(FORBIDDEN))


def run(root: str, cell_name: str, seed: int, seconds: float, traced: bool,
        device, t_start: float, log,
        cache_dir: str = graphs.CACHE_DIR) -> tuple[dict, list]:
    """One run of ``cell_name``; returns (the result line as a dict, the
    compared numbers as (name, number, limit) rows)."""
    bench = Bench(root)
    limits = bench.limits(cell_name)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact float32
    torch.backends.cudnn.allow_tf32 = False

    cell = bench.cell(cell_name, dev, log, cache_dir)
    w = workload.make(cell, seed)
    log(f"[setup] {time.perf_counter() - t_start:.1f}s")
    log("[kernels] " + kernel_builds(
        time.time() - (time.perf_counter() - t_start)))

    spans = Spans(traced)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    setup_s = time.perf_counter() - t_start
    rec = w.window(seconds, spans)
    trace = None
    if prof is not None:
        prof.stop()
        t0 = time.perf_counter()
        trace = read_trace(prof.profiler.kineto_results.events())
        del prof
        log(f"[trace] read in {time.perf_counter() - t0:.1f}s: "
            f"{trace['device_ops']} device activities")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"[window] {rec['count']} in {rec['window_s']:.3f}s; peak "
        f"{peak} bytes")
    if "counts" not in rec:
        raise ValueError(
            f"traffic kind {cell.traffic['kind']!r}: its window's record "
            "has no 'counts', so no end-to-end reader knows what its "
            f"count of {rec['count']} counts")

    w.release()
    cell.release()
    t0 = time.perf_counter()
    checks, answers = w.judge(cell.reference())
    log(f"[judge] {len(answers)} answers in {time.perf_counter() - t0:.1f}s")
    rows = [(name, checks.get(name), lim) for name, lim in limits.items()]
    correct = all(v is not None and v <= lim for _, v, lim in rows) \
        and set(checks) <= set(limits)
    failed = sum(1 for name, v in answers if not v <= limits[name])

    rec.update(kind=cell.traffic["kind"], cfg=cell.cfg,
               traffic=cell.traffic, m=cell.m, n=cell.g.n, nnz=cell.nnz,
               setup_s=setup_s, spans=spans.durations, trace=trace)
    metrics = {}
    wanted = bench.metrics(cell_name, traced)
    for m in wanted:
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    missing = [m["name"] for m in wanted if m["name"] not in metrics]
    if missing and not traced:
        raise ValueError(
            f"cell {cell_name!r} is listed under {', '.join(missing)}, "
            f"which found nothing to read in a window that counts "
            f"{rec['counts']!r} (traffic kind {rec['kind']!r})")
    info = card_info(dev)
    info["memory_peak_bytes"] = int(peak)
    line = {"correct": bool(correct), "attempted": rec["count"],
            "failed": failed, "metrics": metrics, "device": info}
    if trace is not None:
        info["busy_s"], info["window_s"] = trace["busy_s"], trace["window_s"]
        line["breakdown"] = trace["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return line, rows
