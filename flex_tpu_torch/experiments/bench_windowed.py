"""The windowed hybrid against ELL on reddit_posts, through the harness.

Counterpart of ``experiments/bench_windowed.py``: each spec string
(``method[,key=value...]``: for ``windowed`` the keys ``tm`` (default 256),
``W`` (256), ``J`` (16), ``mc`` (min_count, 128), ``impl`` and ``bdt``
(the residue's gather dtype); for ``ell`` ``bdt``; for any method
``iters`` (10) and ``check`` (1)) goes through
:func:`..bench.harness.bench_spmm` at k = 128 on the cached
``reddit_posts_<which>`` graph (:func:`.gen_graphs.cached`; rbdeg is the
headline's own), and prints the harness's ``_fmt`` line with the wall
seconds and the extra columns.  The script read ``/tmp`` npz files and
configured the JAX compile cache; neither exists here.

    python -m flex_tpu_torch.experiments.bench_windowed rbdeg \\
        windowed,W=128,J=1024,mc=64 ell
"""
from __future__ import annotations

import sys
import time

from flex_tpu_torch.bench.harness import _fmt, bench_spmm
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.sparse.device import resolve_device

SPECS = ("windowed,W=128,J=1024,mc=64", "windowed,W=128,J=1024,mc=128",
         "ell")


def parse(spec: str) -> tuple[str, dict, dict]:
    """(method, prepare keywords, harness keywords) of a spec string."""
    parts = dict(q.split("=") for q in spec.split(",") if "=" in q)
    method = spec.split(",")[0]
    kw = {}
    if method == "windowed":
        kw = dict(tm=int(parts.get("tm", 256)), W=int(parts.get("W", 256)),
                  J=int(parts.get("J", 16)),
                  min_count=int(parts.get("mc", 128)),
                  impl=parts.get("impl", "pallas"))
        if "bdt" in parts:
            kw["b_dtype"] = parts["bdt"]
    elif method == "ell" and "bdt" in parts:
        kw = dict(b_dtype=parts["bdt"])
    return method, kw, dict(iters=int(parts.get("iters", 10)),
                            check=parts.get("check", "1") != "0")


def main(which: str = "rbdeg", specs=SPECS, device=None, graph=None,
         k: int = 128) -> dict:
    """Every spec on ``graph`` (the cached reddit_posts ordered by
    ``which`` by default).  Returns spec -> BenchResult."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.experiments.gen_graphs import cached

        graph = cached("reddit_posts", which)
    out = {}
    for spec in specs:
        method, kw, hk = parse(spec)
        t0 = time.time()
        r = bench_spmm(graph, k, method=method, device=dev, **hk, **kw)
        p(f"{_fmt(r)} wall={time.time()-t0:.0f}s {r.extra}")
        out[spec] = r
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "rbdeg",
         tuple(sys.argv[2:]) or SPECS)
