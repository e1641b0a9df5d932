"""spmm_gflops: 2·nnz·k operations of each SpMM call in the window, over
the window's seconds (a synchronise at each end)."""
from spmm_bench.arith import spmm_flops


def read(rec):
    if rec["kind"] != "stream":
        return None
    return spmm_flops(rec["nnz"], rec["traffic"]["k"]) * rec["count"] \
        / rec["window_s"] / 1e9
