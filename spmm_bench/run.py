"""Run one cell of the benchmark once.

    python3 spmm_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on stdout (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number beside its limit); everything
else goes to stderr, the compared numbers last.  Exits non-zero and
prints no result without enough CUDA cards, when the program cannot be
imported, or when JAX or its package is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host thread pools of torch and of the
# BLAS hold one thread each, so the host path's speed does not depend on
# how spinning pool threads share the machine's cores with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from spmm_bench import harness

    log(f"[start] torch {torch.__version__} imported")

    chips = harness.Bench(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import flex_tpu_torch  # noqa: F401  (fails where the program is absent)

    log("[start] card found, program imported")

    line, rows = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START, log)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    log(f"correct: {line['correct']}")
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
