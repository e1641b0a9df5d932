"""spmm_gflops: 2·nnz·k operations of each SpMM call in the window, over
the window's seconds (a synchronise at each end).  Read in any cell whose
window counts SpMM calls (``counts`` is ``spmm_calls``) at the traffic's
width ``k``, of whatever traffic kind."""
from spmm_bench.arith import spmm_flops


def read(rec):
    if rec.get("counts") != "spmm_calls":
        return None
    return spmm_flops(rec["nnz"], rec["traffic"]["k"]) * rec["count"] \
        / rec["window_s"] / 1e9
