"""The general part of every cell: the configuration's graph, ordering
and plan (:class:`Cell`), the base of every traffic kind
(:class:`Workload`), and the lookup of the files a cell names by name.

A traffic file (``traffic/<name>.json``) names a ``kind`` and gives its
parameters; a configuration file (``configs/<name>.json``) gives the graph,
its ordering, the autotuner's arguments and the model (``model.kind`` and
its widths).  Each kind and each model is a file of its own, found by
name in the benchmark's folder:

- ``kinds/<kind>.py``: ``WORKLOAD``, a :class:`Workload` subclass (set-up
  and warm-up in its constructor, then ``window``, ``release``,
  ``judge`` and ``control``), and ``FAULTS``, the names of
  :mod:`spmm_bench.faults` that a run of it can have;
- ``models/<model kind>.py``: the program's model with the benchmark's
  weights: ``weights(md, gen, device)``, ``build(cell, params)`` (it
  sees the cell's graph, so a model that needs more than the plan can
  prepare it there) and ``loss(model, plan, X, y, mask)``;
- ``reference/<model kind>.py``: the model's plain ``forward``.

The graph and its ordering are the configuration's (seed 0 of the
generator); ``--seed`` makes everything else on the device: B operands,
features, labels, the training mask and the model's weights.  The program
is driven through its public entry points only: ``reorder.compute_order``,
``sparse.perm.apply_vertex_order``, ``sparse.device.DeviceCSR``,
``bench.autotune.suggest``, ``ops.prepare_fn`` and what the kind and the
model files call.

Each kind keeps a sample of its answers, drawn from the seed, and
:meth:`Workload.judge` compares them with the plain reference once the
window has closed and the program's state is released.
"""
from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import random
import sys
import time

import torch

from spmm_bench import graphs
from spmm_bench.reference import common as ref

TINY = 1e-30


def load(bench_dir: str, folder: str, name: str, what: str):
    """The module ``<bench_dir>/<folder>/<name>.py``, loaded once by its
    path; ``what`` names it in the error where there is no such file."""
    path = os.path.join(bench_dir, folder, f"{name}.py")
    if not os.path.exists(path):
        raise ValueError(f"unknown {what} {name!r}: no file {folder}/"
                         f"{name}.py in {bench_dir}")
    key = "spmm_bench_found_" + hashlib.sha256(
        os.path.abspath(path).encode()).hexdigest()[:16]
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return mod


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of a seed's independent streams
    (0: operands or features, 1: labels and mask, 2: weights)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 16 + stream)
    return g


def glorot(shape, gen, device) -> torch.Tensor:
    """Glorot-uniform float32 weights, the port's initializer's law."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * limit


class Cell:
    """What every seed of a cell shares: the graph, the port's ordering,
    the ordered graph on the device, the autotuner's choice of plan, and
    the cell's traffic kind, model and model reference, found by name in
    ``bench_dir`` (an unknown name raises)."""

    def __init__(self, cfg: dict, traffic: dict, device, log,
                 cache_dir: str = graphs.CACHE_DIR,
                 bench_dir: str = graphs.BENCH_DIR):
        from flex_tpu_torch.ops import prepare_fn
        from flex_tpu_torch.reorder import ORDER_ABBR
        from flex_tpu_torch.sparse.csr import CSRGraph
        from flex_tpu_torch.sparse.device import DeviceCSR
        from flex_tpu_torch.sparse.perm import apply_vertex_order

        self.cfg, self.traffic = cfg, traffic
        self.kind = load(bench_dir, "kinds", traffic["kind"], "traffic kind")
        model_kind = cfg["model"]["kind"]
        self.model = load(bench_dir, "models", model_kind, "model kind")
        self.model_ref = load(bench_dir, "reference", model_kind,
                              "model kind")
        self.device = torch.device(device)
        self.arrays = graphs.load_graph(cfg["graph"], log, cache_dir)
        g0 = CSRGraph.from_arrays(*self.arrays, name=cfg["name"])
        self.perm = graphs.port_order(g0, cfg["graph"], cfg["order"], log,
                                      cache_dir)
        t0 = time.perf_counter()
        self.g = apply_vertex_order(g0, self.perm, ORDER_ABBR[cfg["order"]],
                                    check=False)
        self.csr = DeviceCSR.from_graph(self.g, self.device)
        sync(self.device)
        log(f"[cell] ordered and uploaded in {time.perf_counter() - t0:.1f}s")
        self.method, self.prep_kwargs = graphs.port_suggest(
            self.g, cfg, log, cache_dir)
        self.prepare = prepare_fn(self.method)
        self.m, self.nnz = self.g.m, self.g.nnz

    def build(self, **options):
        """A plan of the autotuner's method from the resident CSR;
        ``options`` add to or replace its keyword arguments."""
        return self.prepare(self.g, dev=self.csr,
                            **{**self.prep_kwargs, **options})

    def release(self) -> None:
        """Drop the program's copy of the graph on the device."""
        del self.csr

    def reference(self) -> ref.Adjacency:
        """The reference's own ordered adjacency, from the graph before
        ordering and the port's permutation (checked there)."""
        return ref.Adjacency(*self.arrays, self.perm, self.device)


def make(cell: Cell, seed: int, plan_options: dict | None = None):
    """The workload of ``cell``'s traffic kind for ``seed``: inputs made,
    the program's plan built and every shape the window uses warmed up."""
    return cell.kind.WORKLOAD(cell, seed, plan_options or {})


class Workload:
    """One seed's run of a cell: set-up in the constructor, then
    :meth:`window` (returns the record the metrics read: ``count``,
    ``counts``, which names what ``count`` counts, and ``window_s`` at
    least), :meth:`release` and :meth:`judge`, which
    returns the compared numbers by name and each judged answer as
    (name, number); :meth:`control` puts the reference in TF32 in the
    program's place before :meth:`judge`."""

    def __init__(self, cell: Cell, seed: int, plan_options: dict):
        self.cell, self.seed, self.plan_options = cell, seed, plan_options
        self.dev = cell.device
        self.kept: list = []      # (pool index, answer) judged later
        self.keep_at: set = set()

    def weights(self) -> list:
        """The model's weights from the seed, on the device."""
        return self.cell.model.weights(self.cell.cfg["model"],
                                       generator(self.dev, self.seed, 2),
                                       self.dev)

    def port_model(self, params):
        """The program's model with ``params`` copied in."""
        return self.cell.model.build(self.cell, params)

    def _choose_kept(self, per_op_s: float, seconds: float, like) -> None:
        """Draw from the seed which answers of the window to keep: a sample
        of ``traffic["sample"]`` among the first half of the answers the
        window is expected to give, besides the last.  Their storage, like
        ``like``, is made here, so that keeping one inside the window
        allocates nothing."""
        expect = max(int(seconds / max(per_op_s, 1e-6) / 2), 1)
        n = min(self.cell.traffic["sample"], expect)
        self.keep_at = set(random.Random(self.seed).sample(range(expect), n))
        self._store = [torch.empty_like(like) for _ in range(n + 1)]

    def _keep(self, j: int, answer) -> None:
        """Keep a copy of ``answer``, made from pool entry ``j``."""
        buf = self._store[len(self.kept)]
        buf.copy_(answer)
        self.kept.append((j, buf))

    def window(self, seconds: float, spans) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def judge(self, A: ref.Adjacency) -> tuple[dict, list]:
        raise NotImplementedError

    def control(self, A: ref.Adjacency) -> None:
        raise NotImplementedError


class SpmmJudged(Workload):
    """Judges kept SpMM outputs C_j against A'·B_j: the largest gap of an
    output over its scale |A'|·|B_j| (float64), ``spmm_err``.  A subclass
    sets ``self.B``, the pool of operands."""

    def judge(self, A):
        worst, answers = 0.0, []
        for j, C in self.kept:
            B = self.B[j]
            err = ((C.to(torch.float64) - A.mm(B)).abs()
                   / (A.abs_mm(B) + TINY)).max()
            e = float(err) if torch.isfinite(err) else math.inf
            answers.append(("spmm_err", e))
            worst = max(worst, e)
        return {"spmm_err": worst}, answers

    def control(self, A):
        """The reference in TF32 in the program's place."""
        self.kept = [(j, A.mm(self.B[j], "tf32")) for j, _ in self.kept]
