"""gat_train_mfu: a GAT step's model operations
(:func:`spmm_bench.arith_gat.gat_train_step_flops`: the dense and score
products, the aggregations in both directions and the per-edge dot
products, no pads) times the steps, over the traced window's seconds at
the published float32 peak.  In %.

Keyed on the kind's name, ``train``, and not on what the window
counts: it takes each counted step for a full-graph step, which a
sampled step (a subgraph a step) is not.  A new kind brings per-layer
readers of its own."""
from spmm_bench.arith import PEAK_FP32_FLOPS
from spmm_bench.arith_gat import gat_train_step_flops


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" \
            or rec["cfg"]["model"]["kind"] != "gat3" or not tr:
        return None
    md = rec["cfg"]["model"]
    flops = gat_train_step_flops(rec["m"], rec["nnz"], md["d_in"],
                                 md["heads"], md["widths"], md["combine"])
    return flops * rec["count"] / (tr["window_s"] * PEAK_FP32_FLOPS) * 100
