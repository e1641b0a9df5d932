"""A small copy of the benchmark for the CPU tests: ``BENCHMARK.json`` and
the benchmark's data files copied into a temporary root, with one more
configuration, ``tiny-gcn`` (a 3,000-node graph from the same generator,
GCN 20 -> 16 -> 5), and a cell of it for each traffic mix, held to the
limits of the Reddit (Flickr for ``infer``) cell of that mix.  The
harness's code is the repository's."""
from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
TRAFFIC = ("spmm", "train", "infer")


def copy_bench(root: str) -> None:
    """BENCHMARK.json and the benchmark's folder (no cache) under ``root``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "spmm_bench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))


def tiny_root(root: str, m: int = 3000, nnz: int = 60000) -> str:
    """A root whose BENCHMARK.json also has the ``tiny-gcn.<traffic>``
    cells; returns ``root``."""
    from spmm_bench.data import synth

    copy_bench(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(BENCH, "configs", "reddit-gcn.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-gcn"
    cfg["graph"]["params"].update(m=m, nnz_target=nnz)
    cfg["graph"].update(nodes=m, nnz=len(synth.bipartite_projection_graph(
        **cfg["graph"]["params"])[1]))
    cfg["model"].update(d_in=20, d_hidden=16, n_classes=5)
    with open(os.path.join(root, "spmm_bench", "configs", "tiny-gcn.json"),
              "w") as f:
        json.dump(cfg, f)
    spec["configs"].append({"name": "tiny-gcn", "source": "test",
                            "file": "spmm_bench/configs/tiny-gcn.json",
                            "reduced": [], "why": "test"})
    for t in TRAFFIC:
        cell = f"tiny-gcn.{t}"
        spec["workloads"].append({"name": cell, "config": "tiny-gcn",
                                  "traffic": t, "chips": 1, "why": "test"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if f"reddit-gcn.{t}" in metric.get("workloads", ()) or \
                    f"flickr-gcn.{t}" in metric.get("workloads", ()):
                metric["workloads"].append(cell)
        shutil.copy(os.path.join(BENCH, "limits", f"reddit-gcn.{t}.json"
                                 if t != "infer" else "flickr-gcn.infer.json"),
                    os.path.join(root, "spmm_bench", "limits",
                                 f"{cell}.json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def run(root: str, cell: str, trace: bool = False, seed: int = 2**31 + 7,
        device: str = "cpu", seconds: float = 0.3):
    """harness.run on ``root`` with a cache beside it; returns (line,
    rows).  The program's span registry starts empty, as in the new
    process of every ``run.py``: the spans of an earlier run in this
    process (with device seconds, where it ran on the card) would
    otherwise be read as this run's."""
    import time

    from flex_tpu_torch.utils import trace as program_trace

    from spmm_bench import harness

    program_trace.reset()
    return harness.run(root, cell, seed, seconds, trace, device,
                       time.perf_counter(), lambda msg: None,
                       cache_dir=os.path.join(root, "cache"))
