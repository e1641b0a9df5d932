"""Readings that the limits of ``limits/<cell>.json`` are set from: the
compared numbers of one cell over many seeds, in one process that builds
the cell's graph and ordering once.

    python3 spmm_bench/calibrate.py --workload <cell> --seconds 1 \
        --run program=1-12 --run control=101-103 \
        [--run bf16=201-203] [--run fault:half_batch=301-303]

Modes: ``program`` (the run as the benchmark makes it, with a short
window), ``control`` (the plain reference in TF32 put in the program's
place, judged against the float64 reference), ``bf16`` (the program with
its own bfloat16 gather switched on, ``b_dtype="bfloat16"``) and
``fault:<name>`` (a fault of :mod:`spmm_bench.faults` planted under the
program).  Prints one JSON line per run and, last, each mode's largest
and smallest reading of each number.  Runs on the card unless
``--device`` names another.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_START = time.perf_counter()
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"  # as run.py: one thread in each host pool


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def seeds_of(text: str) -> list[int]:
    """'1-12' or '5,9,10' (or a mix) as a list of seeds."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--run", action="append", required=True,
                    help="<mode>=<seeds>")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from spmm_bench import faults, harness, workload
    from spmm_bench.trace import Spans

    bench = harness.Bench(ROOT)
    limits = bench.limits(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.cell(args.workload, args.device, log)
    A = cell.reference()
    readings: dict = {}
    for spec in args.run:
        mode, _, seeds = spec.partition("=")
        for seed in seeds_of(seeds):
            fault = mode.split(":", 1)[1] if mode.startswith("fault:") \
                else None
            options = {"b_dtype": "bfloat16"} if mode == "bf16" else {}
            ctx = faults.plant(fault) if fault else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                w = workload.make(cell, seed, options)
                rec = w.window(args.seconds, Spans())
            w.release()
            if mode == "control":
                w.control(A)
            checks, _ = w.judge(A)
            print(json.dumps({"mode": mode, "seed": seed, "checks": checks,
                              "detail": getattr(w, "detail", None),
                              "count": rec["count"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            del w
            for name, v in checks.items():
                readings.setdefault(mode, {}).setdefault(name, []).append(v)
    summary = {mode: {name: {"max": max(vs), "min": min(vs), "n": len(vs)}
                      for name, vs in by.items()}
               for mode, by in readings.items()}
    print(json.dumps({"workload": args.workload, "method": cell.method,
                      "limits": limits, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
