"""infer_p95_ms: the 95th percentile of every request's latency in the
window, from its start to the synchronise's return on the host clock.
Read in any cell whose window counts requests (``counts`` is
``requests``) and keeps their ``latencies``, of whatever traffic kind."""
from spmm_bench.arith import percentile


def read(rec):
    if rec.get("counts") != "requests" or "latencies" not in rec:
        return None
    return percentile(rec["latencies"], 95) * 1e3
