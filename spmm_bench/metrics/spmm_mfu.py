"""spmm_mfu: the stream's SpMM operations (2·nnz·k a call) over the
traced window's seconds at the published float32 peak.  In %.

Keyed on the kind's name, ``stream``, and not on what the window
counts: it takes each counted call for an SpMM over the whole graph,
which a call of another kind (on a sampled subgraph, say) is not.  A
new kind brings per-layer readers of its own."""
from spmm_bench.arith import PEAK_FP32_FLOPS, spmm_flops


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "stream" or not tr:
        return None
    return spmm_flops(rec["nnz"], rec["traffic"]["k"]) * rec["count"] \
        / (tr["window_s"] * PEAK_FP32_FLOPS) * 100
