"""infer_p95_ms: the 95th percentile of every request's latency in the
window, issue to the synchronise's return on the host clock."""
from spmm_bench.arith import percentile


def read(rec):
    if rec["kind"] != "infer":
        return None
    return percentile(rec["latencies"], 95) * 1e3
