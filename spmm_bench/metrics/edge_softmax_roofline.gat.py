"""GAT's edge scores and edge softmax, forward (``flex.edge_softmax``
spans) and backward (``flex.edge_softmax.bwd``), against their least time
(:func:`spmm_bench.arith_edge_softmax.edge_softmax_least_s` at the rows
and edges each span records, the cell's columns), from the program's
spans, in %.  None where the program records no such span with device
seconds, as a program whose softmax is plain tensor code does."""
from spmm_bench.arith_edge_softmax import edge_softmax_least_s
from spmm_bench.program_spans import entries


def read(rec):
    calls = [(e, backward)
             for name, backward in (("flex.edge_softmax", False),
                                    ("flex.edge_softmax.bwd", True))
             for e in entries(name) if e["device_s"] > 0]
    if not calls:
        return None
    least = sum(e["count"] * edge_softmax_least_s(
        e["attrs"]["m"], rec["n"], e["attrs"]["nnz"], backward)
        for e, backward in calls)
    return least / sum(e["device_s"] for e, _ in calls) * 100
