"""gcn_infer_mfu: a forward's model operations over the mean request
latency at the published float32 peak.  In %.

Keyed on the kind's name, ``infer``, and not on what the window
counts: it takes each request for a forward over the whole graph, which
a request of another kind need not be.  A new kind brings per-layer
readers of its own."""
from spmm_bench.arith import PEAK_FP32_FLOPS, gcn_forward_flops


def read(rec):
    if rec["kind"] != "infer" \
            or rec["cfg"]["model"]["kind"] != "gcn2" or not rec.get("trace"):
        return None
    md = rec["cfg"]["model"]
    flops = gcn_forward_flops(rec["m"], rec["nnz"], md["d_in"],
                              md["d_hidden"], md["n_classes"])
    mean_s = sum(rec["latencies"]) / len(rec["latencies"])
    return flops / (mean_s * PEAK_FP32_FLOPS) * 100
