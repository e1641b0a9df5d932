"""Additions made as new files (with their entries in BENCHMARK.json) are
found by name, and no file that was there changes: a configuration, a
traffic mix, a per-layer metric, a traffic kind (``kinds/<kind>.py``)
and a model (``models/<kind>.py`` with ``reference/<kind>.py``).  A
model or traffic kind with no file raises.  The end-to-end readers key
on what a window counts, not on the kind's name, so a new kind reports
the end-to-end metric the benchmark has; a window that does not say
what it counts, or a cell that lacks an end-to-end metric it is listed
under, raises."""
import hashlib
import json
import os
import shutil

import pytest

from spmm_bench import harness
from spmm_bench.arith import percentile, spmm_flops
from spmm_bench.tests.small import BENCH, REPO, copy_bench, run

# a traffic kind: two SpMMs in a row, C = A'·(A'·B), judged against the
# reference's over |A'|·|A'|·|B|
CHAIN = '''
import math
import time

import torch

from spmm_bench.workload import TINY, Workload, generator, sync

FAULTS = ("answer",)


class Chain(Workload):
    def __init__(self, cell, seed, plan_options):
        super().__init__(cell, seed, plan_options)
        t = cell.traffic
        self.B = torch.randn((t["pool"], cell.g.n, t["k"]),
                             generator=generator(self.dev, seed, 0),
                             device=self.dev)
        self.plan = cell.build(**plan_options)
        self.like = self.plan(self.plan(self.B[0]))
        sync(self.dev)

    def window(self, seconds, spans):
        self._choose_kept(1e-3, seconds, self.like)
        P, i = len(self.B), 0
        t0 = time.perf_counter()
        while True:
            C = self.plan(self.plan(self.B[i % P]))
            if i in self.keep_at:
                self._keep(i % P, C)
            i += 1
            if time.perf_counter() >= t0 + seconds:
                break
        sync(self.dev)
        return {"count": i, "counts": "chain_calls",
                "window_s": time.perf_counter() - t0}

    def release(self):
        del self.plan, self.like

    def judge(self, A):
        worst, answers = 0.0, []
        for j, C in self.kept:
            R = A.mm(A.mm(self.B[j]))
            S = A.abs_mm(A.abs_mm(self.B[j]))
            e = float(((C.double() - R).abs() / (S + TINY)).max())
            e = e if math.isfinite(e) else math.inf
            answers.append(("chain_err", e))
            worst = max(worst, e)
        return {"chain_err": worst}, answers


WORKLOAD = Chain
'''

# a traffic kind under a new name: the ``train`` kind's steps, in the
# window on alternate halves of the training mask; its record says that
# it counts COUNTS, set by the test (no ``counts`` where None)
HALVES = '''
import os
import time

import torch

from spmm_bench import workload
from spmm_bench.workload import sync

TRAIN = workload.load(os.path.dirname(os.path.dirname(__file__)), "kinds",
                      "train", "traffic kind")
FAULTS = TRAIN.FAULTS
COUNTS = None


class Halves(TRAIN.WORKLOAD):
    def window(self, seconds, spans):
        rows = torch.arange(len(self.mask), device=self.dev)
        halves = [self.mask * (rows % 2 == r) for r in (0, 1)]
        i = 0
        sync(self.dev)
        t0 = time.perf_counter()
        with spans.span("window"):
            while True:
                self.step(self.X, self.y, halves[i % 2])
                i += 1
                if time.perf_counter() >= t0 + seconds:
                    break
            sync(self.dev)
        rec = {"count": i, "window_s": time.perf_counter() - t0}
        if COUNTS is not None:
            rec["counts"] = COUNTS
        return rec


WORKLOAD = Halves
'''

# a model: the program's 2-layer mean-aggregator GraphSAGE
SAGE = '''
import torch

from spmm_bench.workload import glorot


def weights(md, gen, device):
    d, h, c = md["d_in"], md["d_hidden"], md["n_classes"]
    return [glorot((d, h), gen, device), glorot((d, h), gen, device),
            torch.zeros(h, device=device), glorot((h, c), gen, device),
            glorot((h, c), gen, device), torch.zeros(c, device=device)]


def build(cell, params):
    from flex_tpu_torch.models.sage import GraphSAGE

    md = cell.cfg["model"]
    model = GraphSAGE(md["d_in"], md["d_hidden"], md["n_classes"], cell.nnz,
                      generator=torch.Generator().manual_seed(0))
    model = model.to(cell.device)
    with torch.no_grad():
        for p, w in zip(model.parameters(), params):
            p.copy_(w)
    return model


def loss(model, plan, X, y, mask):
    from flex_tpu_torch.models.sage import sage_loss

    return sage_loss(model, plan, X, y, mask)
'''

SAGE_REF = '''
import torch

from spmm_bench.reference.common import matmul, spmm


def forward(A, X, params, mode="f64"):
    Ws1, Wn1, b1, Ws2, Wn2, b2 = params
    h = torch.relu(matmul(X, Ws1, mode) + spmm(A, matmul(X, Wn1, mode), mode)
                   + b1)
    return matmul(h, Ws2, mode) + spmm(A, matmul(h, Wn2, mode), mode) + b2
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _little(bdir, name, model_kind):
    """A small configuration like flickr-gcn's, of ``model_kind``."""
    with open(os.path.join(BENCH, "configs", "flickr-gcn.json")) as f:
        cfg = json.load(f)
    cfg["name"] = name
    cfg["graph"]["params"].update(m=2500, nnz_target=55000)
    from spmm_bench.data import synth

    cfg["graph"]["nnz"] = len(synth.bipartite_projection_graph(
        **cfg["graph"]["params"])[1])
    cfg["graph"]["nodes"] = 2500
    cfg["model"].update(kind=model_kind, d_in=12, d_hidden=8, n_classes=3)
    _write(os.path.join(bdir, "configs", f"{name}.json"), json.dumps(cfg))
    return {"name": name, "source": "test",
            "file": f"spmm_bench/configs/{name}.json", "reduced": [],
            "why": "test"}


def _cell(spec, name, config, traffic):
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "test"})


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    copy_bench(root)
    bdir = os.path.join(root, "spmm_bench")
    before = _digests(bdir)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    e2e = {m["name"]: m for m in spec["end_to_end"]}

    # a configuration and a traffic mix of a kind that is there
    spec["configs"].append(_little(bdir, "little-gcn", "gcn2"))
    _write(os.path.join(bdir, "traffic", "narrow.json"), json.dumps(
        {"kind": "stream", "k": 24, "pool": 3, "sample": 5}))
    _write(os.path.join(bdir, "limits", "little-gcn.narrow.json"),
           json.dumps({"spmm_err": 1e-5}))
    _cell(spec, "little-gcn.narrow", "little-gcn", "narrow")
    e2e["spmm_gflops"]["workloads"].append("little-gcn.narrow")

    # a per-layer metric
    _write(os.path.join(bdir, "metrics", "calls_per_s.py"),
           "def read(rec):\n    return rec['count'] / rec['window_s']\n")
    spec["per_layer"].append({"name": "calls_per_s", "unit": "calls/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "SpMM plan call",
                              "moves": "spmm_gflops",
                              "workloads": ["little-gcn.narrow"]})

    # a traffic kind, its mix, its end-to-end metric and its cell
    _write(os.path.join(bdir, "kinds", "chain.py"), CHAIN)
    _write(os.path.join(bdir, "traffic", "chain.json"), json.dumps(
        {"kind": "chain", "k": 16, "pool": 2, "sample": 3}))
    _write(os.path.join(bdir, "limits", "little-gcn.chain.json"),
           json.dumps({"chain_err": 1e-5}))
    _write(os.path.join(bdir, "metrics", "chain_ms.py"),
           "def read(rec):\n"
           "    if rec['counts'] != 'chain_calls':\n"
           "        return None\n"
           "    return rec['window_s'] / rec['count'] * 1e3\n")
    spec["end_to_end"].append({"name": "chain_ms", "unit": "ms",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["little-gcn.chain"]})
    _cell(spec, "little-gcn.chain", "little-gcn", "chain")

    # a model and its reference, under the infer and train kinds
    _write(os.path.join(bdir, "models", "sage2.py"), SAGE)
    _write(os.path.join(bdir, "reference", "sage2.py"), SAGE_REF)
    spec["configs"].append(_little(bdir, "little-sage", "sage2"))
    for traffic, metric, src in (("infer", "infer_p95_ms",
                                  "flickr-gcn.infer"),
                                 ("train", "train_step_ms",
                                  "reddit-gcn.train")):
        cell = f"little-sage.{traffic}"
        with open(os.path.join(BENCH, "limits", f"{src}.json")) as f:
            _write(os.path.join(bdir, "limits", f"{cell}.json"), f.read())
        _cell(spec, cell, "little-sage", traffic)
        e2e[metric]["workloads"].append(cell)
    _write(spec_path, json.dumps(spec))

    line, _ = run(root, "little-gcn.narrow")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"spmm_gflops", "setup_s"}
    line, _ = run(root, "little-gcn.narrow", trace=True)
    assert "calls_per_s" in line["metrics"]
    assert "spmm_roofline" not in line["metrics"]  # not listed for it
    line, rows = run(root, "little-gcn.chain")
    assert line["correct"] is True and [r[0] for r in rows] == ["chain_err"]
    assert set(line["metrics"]) == {"chain_ms", "setup_s"}
    for cell in ("little-sage.infer", "little-sage.train"):
        line, rows = run(root, cell)
        assert line["correct"] is True, rows
    # the GCN's mfu reader reads nothing for another model
    line, _ = run(root, "little-sage.infer", trace=True)
    assert "gcn_infer_mfu" not in line["metrics"]

    after = _digests(bdir)
    assert {p: h for p, h in after.items() if p in before} == before
    assert before == {p: h for p, h in _digests(BENCH).items()
                      if "cache" not in p.split(os.sep)
                      and "__pycache__" not in p.split(os.sep)}
    assert os.path.exists(os.path.join(REPO, "BENCHMARK.json"))


@pytest.mark.parametrize("part,what", [("model", "model kind"),
                                       ("traffic", "traffic kind")])
def test_a_kind_with_no_file_raises(tmp_path, part, what):
    root = str(tmp_path)
    copy_bench(root)
    bdir = os.path.join(root, "spmm_bench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(_little(bdir, "little-gat", "gat2"
                                   if part == "model" else "gcn2"))
    _write(os.path.join(bdir, "traffic", "odd.json"), json.dumps(
        {"kind": "sampled" if part == "traffic" else "stream", "k": 8,
         "pool": 1, "sample": 1}))
    _write(os.path.join(bdir, "limits", "little-gat.odd.json"),
           json.dumps({"spmm_err": 1e-5}))
    _cell(spec, "little-gat.odd", "little-gat", "odd")
    _write(os.path.join(root, "BENCHMARK.json"), json.dumps(spec))
    with pytest.raises(ValueError, match=f"unknown {what}"):
        run(root, "little-gat.odd")


@pytest.mark.parametrize("counts,error", [
    ("train_steps", None),
    (None, "has no 'counts'"),
    ("epochs", "listed under train_step_ms"),
], ids=["train_steps", "no counts", "epochs"])
def test_a_new_kind_reports_train_step_ms(tmp_path, counts, error):
    """A kind under a new name whose window counts training steps reports
    ``train_step_ms`` in its cell, with no file of the benchmark edited;
    the per-layer readers of a full-graph step stay silent there.  A
    window that does not say what it counts, or counts something no
    end-to-end metric of its cell reads, raises and names the cause."""
    root = str(tmp_path)
    copy_bench(root)
    bdir = os.path.join(root, "spmm_bench")
    before = _digests(bdir)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append(_little(bdir, "little-gcn", "gcn2"))
    _write(os.path.join(bdir, "kinds", "halves.py"),
           HALVES.replace("COUNTS = None", f"COUNTS = {counts!r}"))
    _write(os.path.join(bdir, "traffic", "halves.json"), json.dumps(
        {"kind": "halves", "lr": 0.01, "first_steps": 3}))
    cell = "little-gcn.halves"
    shutil.copy(os.path.join(BENCH, "limits", "reddit-gcn.train.json"),
                os.path.join(bdir, "limits", f"{cell}.json"))
    _cell(spec, cell, "little-gcn", "halves")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_step_ms", "gcn_train_mfu",
                         "device_idle.train"):
            m["workloads"].append(cell)
    _write(spec_path, json.dumps(spec))

    if error is not None:
        with pytest.raises(ValueError, match=error):
            run(root, cell)
    else:
        line, rows = run(root, cell)
        assert line["correct"] is True, rows
        assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
        assert line["metrics"]["train_step_ms"]["value"] > 0
        line, rows = run(root, cell, trace=True)
        assert line["correct"] is True, rows
        # keyed on the kind's name: a step of another kind is not the
        # full-graph step whose work gcn_train_mfu counts
        assert set(line["metrics"]) == {"device_idle.train"}
    after = _digests(bdir)
    assert {p: h for p, h in after.items() if p in before} == before


# each end-to-end reader's formula as it was when it keyed on the kind's
# name, and a record of that kind
OLD = {
    "train_step_ms": lambda rec: rec["window_s"] / rec["count"] * 1e3,
    "infer_p95_ms": lambda rec: percentile(rec["latencies"], 95) * 1e3,
    "spmm_gflops": lambda rec: spmm_flops(
        rec["nnz"], rec["traffic"]["k"]) * rec["count"]
    / rec["window_s"] / 1e9,
}
RECS = {
    "train_step_ms": {"kind": "train", "counts": "train_steps",
                      "count": 1351, "window_s": 10.003127},
    "infer_p95_ms": {"kind": "infer", "counts": "requests", "count": 400,
                     "window_s": 0.2931,
                     "latencies": [7.0e-4 + 1e-6 * ((i * 37) % 101)
                                   for i in range(400)]},
    "spmm_gflops": {"kind": "stream", "counts": "spmm_calls", "count": 7613,
                    "window_s": 10.001733, "nnz": 23446803,
                    "traffic": {"k": 128}},
}


@pytest.mark.parametrize("name", sorted(OLD))
def test_end_to_end_readers_keep_their_formulas(name):
    read = harness.Bench(REPO).reader(name)
    for metric, rec in RECS.items():
        if metric == name:
            want = OLD[name](rec)
            assert read(rec) == want  # to the last bit
            assert read({**rec, "kind": "sampled"}) == want
            assert read({k: v for k, v in rec.items()
                         if k != "counts"}) is None
        else:
            assert read(rec) is None
    no_latencies = {k: v for k, v in RECS["infer_p95_ms"].items()
                    if k != "latencies"}
    assert read(no_latencies) is None
