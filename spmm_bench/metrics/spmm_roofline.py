"""spmm_roofline: the SpMM's least time (its bytes at the memory's peak
or its operations at the float32 peak, whichever is longer) over the
device time a call took: every device activity in the traced window,
whatever its name, over the calls.  In %.

Keyed on the kind's name, ``stream``, and not on what the window
counts: its least time is that of an SpMM over the whole graph, which a
call of another kind (on a sampled subgraph, say) is not.  A new kind
brings per-layer readers of its own."""
from spmm_bench.arith import spmm_least_s


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "stream" or not tr or tr["device_s"] <= 0:
        return None
    least = spmm_least_s(rec["m"], rec["n"], rec["nnz"], rec["traffic"]["k"])
    return least / (tr["device_s"] / rec["count"]) * 100
