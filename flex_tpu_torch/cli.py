"""Command-line interface.

    python -m flex_tpu_torch <graph.csv> <k> [--order=deg] [--method=auto]
        [--order-file=perm.npy] [--csv=out.csv] [--trace=DIR]
        [--device=cpu] [--<FlexConfig field>=value ...]

Counterpart of ``flex_tpu.cli``, step by step: prints the device banner and
the graph's statistics, applies the ordering (reloading ``--order-file``
when it exists, else computing and saving it), runs the requested SpMM
strategy (``auto`` asks the autotuner; the user's explicit flags win; a
chosen format that refuses the graph falls back to ``ell``) or the
ordering × method sweep, checks the result against SciPy, and prints the
report line, the trace table with the port's spans (also written as
``spans.json`` beside the trace) and the CSV.  Runs on the card unless
``--device=cpu`` is given.  The last line counts each hand kernel's
launches in the run.  Exit status 1 on a failed check.
"""
from __future__ import annotations

import json
import os
import sys


def _print_launches() -> None:
    from flex_tpu_torch.kernels import launch_counts

    print(f"kernel launches: {json.dumps(launch_counts())}")


def main(argv=None) -> int:
    from flex_tpu_torch.config import FlexConfig

    cfg, pos = FlexConfig.from_args(argv if argv is not None else sys.argv[1:])
    if len(pos) < 1:
        print(__doc__)
        return 2
    path = pos[0]
    if len(pos) > 1:
        cfg.k = int(pos[1])

    from flex_tpu_torch.bench.autotune import suggest
    from flex_tpu_torch.bench.harness import _fmt, bench_spmm, write_csv
    from flex_tpu_torch.io import load_csv
    from flex_tpu_torch.utils.device_info import device_banner

    print(device_banner(cfg.device))
    g = load_csv(path)
    s = g.stats
    print(f"{g}")
    print(
        f"  one-way edges={s.n_edges_one_way} asymmetric={s.n_edges_asymmetric} "
        f"zero-out={s.n_nodes_zero_out} zero-in={s.n_nodes_zero_in} "
        f"zero-deg={s.n_nodes_zero_deg} unit-rows={s.n_unit_rows} "
        f"directed={s.is_directed}"
    )
    print(f"  degree histogram [0,2) [2,4) [4,8) [8,16) [16,inf): "
          f"{g.degree_histogram().tolist()}")

    if cfg.method == "sweep":
        # ordering × tile height × method, each ordering applied by the
        # sweep itself to the graph as loaded
        from flex_tpu_torch.bench.harness import sweep

        results = sweep(
            g, ks=(cfg.k,),
            orders=("ovo", "deg", "rcm", "dfs", "gorder", "rabbit"),
            methods=("xla", "bcoo", "ell", "panel", "band", "windowed"),
            tms=(128, 256), csv_path=cfg.csv,
            check=cfg.check, iters=cfg.iters, device=cfg.device,
        )
        bad = [r for r in results if r.check is not None and not r.check.ok]
        # a format refusing the graph (ValueError / NotImplementedError) is
        # an expected row; any other error is a failure
        crashed = [r for r in results
                   if r.check is None and "error" in r.extra
                   and not r.extra["error"].startswith(
                       ("ValueError", "NotImplementedError"))]
        _print_launches()
        return 1 if bad or crashed else 0

    if cfg.order != "ovo":
        from flex_tpu_torch.reorder import ORDER_ABBR, compute_order
        from flex_tpu_torch.reorder.inout import load_order, save_order
        from flex_tpu_torch.sparse.perm import apply_vertex_order

        of = cfg.order_file
        if of and os.path.exists(of if of.endswith(".npy") else of + ".npy"):
            print(f"loading ordering from {of}")
            perm = load_order(of)
        else:
            print(f"applying ordering: {cfg.order}")
            perm = compute_order(g, cfg.order)
            if of:
                save_order(perm, of)
                print(f"saved ordering to {of}")
        g = apply_vertex_order(g, perm, ORDER_ABBR[cfg.order], check=False)

    method = cfg.method
    if method == "auto":
        # the user's explicit flags go into the autotuner's model, which
        # would otherwise score its own defaults
        sug_kw = {}
        if "tm" in cfg.explicit:
            sug_kw["win_tm"] = max(cfg.tm, 256)
        if "W" in cfg.explicit:
            sug_kw["win_W"] = cfg.W
        if "min_count" in cfg.explicit:
            sug_kw["win_min_count"] = cfg.min_count
        sug = suggest(g, cfg.k, tm=cfg.tm, hub_threshold=cfg.hub_threshold,
                      **sug_kw)
        method = sug.method
        # the autotuner's parameters take precedence over the defaults,
        # never over flags the user set
        prep_kwargs = {**cfg.prep_kwargs(method), **sug.prep_kwargs}
        user = {k: v for k, v in cfg.prep_kwargs(method).items()
                if k in cfg.explicit}
        prep_kwargs.update(user)
        if "J" in cfg.explicit:
            # suggest() has no J knob: let prepare select again with it
            prep_kwargs.pop("sel", None)
        print(f"auto-selected method: {method} ({sug.reason})")
    else:
        prep_kwargs = cfg.prep_kwargs(method)

    try:
        r = bench_spmm(
            g, cfg.k, method=method, iters=cfg.iters, check=cfg.check,
            trace_dir=cfg.trace, device=cfg.device, **prep_kwargs,
        )
    except (ValueError, NotImplementedError) as e:
        if cfg.method != "auto" or method == "ell":
            raise
        print(f"{method} refused ({e}); falling back to ell")
        method = "ell"
        r = bench_spmm(g, cfg.k, method="ell", iters=cfg.iters,
                       check=cfg.check, trace_dir=cfg.trace,
                       device=cfg.device, **cfg.prep_kwargs("ell"))
    print(_fmt(r))
    if cfg.trace:
        from flex_tpu_torch.utils import trace

        rows = trace.trace_table(cfg.trace)
        if rows:
            where = "device" if r.extra.get("trace_device_ms") else "host op"
            print(trace.format_trace_table(rows))
            print(f"trace: {len(rows)} distinct ops; "
                  f"total {sum(x['total_ms'] for x in rows):.2f} ms {where} "
                  f"time in {cfg.trace}")
        spans = trace.snapshot()
        print(trace.format_span_table(spans))
        os.makedirs(cfg.trace, exist_ok=True)
        path = os.path.join(cfg.trace, trace.SPANS_FILE)
        with open(path, "w") as f:
            json.dump(spans, f, indent=1)
        print(f"spans: {len(spans)} aggregates in {path}")
    if cfg.csv:
        write_csv([r], cfg.csv)
        print(f"wrote {cfg.csv}")
    _print_launches()
    if r.check is not None and not r.check.ok:
        print(f"RESULT CHECK FAILED: {r.check}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
