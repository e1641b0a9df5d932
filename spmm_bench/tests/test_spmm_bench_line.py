"""The result line has the contract's keys, ``BENCHMARK.json`` keeps the
contract's rules, and a run without a card or without the program prints
no result."""
import json
import os
import re
import subprocess
import sys

import pytest

from spmm_bench import harness
from spmm_bench.tests.small import BENCH, REPO, TRAFFIC, copy_bench, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("trace", [False, True])
def test_line_has_the_contracts_keys(tiny, traffic, trace):
    line, rows = run(tiny, f"tiny-gcn.{traffic}", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(line) == keys + ["checks"]  # the compared numbers last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = set(line["device"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= dev
    assert trace == ({"busy_s", "window_s"} <= dev)
    bench = harness.Bench(tiny)
    want = {m["name"] for m in bench.metrics(f"tiny-gcn.{traffic}", trace)}
    if not trace:
        assert set(line["metrics"]) == want  # every end-to-end metric
    assert set(line["metrics"]) <= want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
        assert isinstance(v["value"], float) and v["value"] == v["value"]
    if trace:
        for key in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][key]) <= 10
    assert {name for name, _, _ in rows} == set(line["checks"])
    json.dumps(line)


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["spmm_bench"]
    assert spec["command"] == ["python3", "spmm_bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    cells = {w["name"]: w for w in spec["workloads"]}
    assert len(cells) == len(spec["workloads"]) <= 24
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    per = {m["name"]: m for m in spec["per_layer"]}
    assert len(set(e2e) | set(per)) == len(e2e) + len(per)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("spmm_bench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        kind = cfg["model"]["kind"]  # its model and reference, by name
        for part in ("models", "reference"):
            assert os.path.exists(os.path.join(BENCH, part, f"{kind}.py"))
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        for part in ("traffic", "limits"):
            stem = w["traffic"] if part == "traffic" else w["name"]
            assert os.path.exists(os.path.join(BENCH, part, f"{stem}.json"))
        with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(BENCH, "kinds", f"{kind}.py"))
        reported = [n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in per.values())
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
    for text in [x["why"] for x in spec["configs"] + spec["workloads"]] + \
            [m["layer"] for m in spec["per_layer"]] + \
            [c["source"] for c in spec["configs"]] + spec["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(spec)) <= 64 * 1024
    # a full check with 24 cells fits: 2 + 14·24 runs
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "spmm_bench/run.py", "--workload", "reddit-gcn.spmm",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_no_result_without_a_card():
    r = _run_py(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""


def test_no_result_without_the_program(tmp_path):
    copy_bench(str(tmp_path))
    r = _run_py(str(tmp_path), {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax.numpy", "flex_tpu_torch.ops", "flex_tpu", "jaxlib",
             "flax.linen", "jaxtyping", "flex_tpu_torch"]
    assert harness.forbidden_modules(names) == ["flax", "flex_tpu", "jax",
                                                "jaxlib"]


def test_kernel_builds_tells_read_from_built(tmp_path, monkeypatch):
    from flex_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    old, new = tmp_path / "libold.so", tmp_path / "libnew.so"
    old.write_bytes(b"")
    new.write_bytes(b"")
    os.utime(old, (1000.0, 1000.0))
    os.utime(new, (3000.0, 3000.0))
    assert harness.kernel_builds(2000.0) == \
        f"1 read from {tmp_path}, 1 built in this run"
