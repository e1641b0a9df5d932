"""gcn_train_mfu: a step's model operations (four SpMMs at the layers'
widths and the dense products the step needs, no pads) times the steps,
over the traced window's seconds at the published float32 peak.  In %.

Keyed on the kind's name, ``train``, and not on what the window
counts: it takes each counted step for a full-graph step, which a
sampled step (a subgraph a step) is not.  A new kind brings per-layer
readers of its own."""
from spmm_bench.arith import PEAK_FP32_FLOPS, gcn_train_step_flops


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" \
            or rec["cfg"]["model"]["kind"] != "gcn2" or not tr:
        return None
    md = rec["cfg"]["model"]
    flops = gcn_train_step_flops(rec["m"], rec["nnz"], md["d_in"],
                                 md["d_hidden"], md["n_classes"])
    return flops * rec["count"] / (tr["window_s"] * PEAK_FP32_FLOPS) * 100
