"""g_vals, the per-edge dot products of the GAT step's backward
(``flex.edge_dots`` spans), against their least time
(:func:`spmm_bench.arith_gat.edge_dots_least_s` at the widths each span
records, the cell's rows and columns), from the program's spans, in %.
None where the program records no such span with device seconds."""
from spmm_bench.arith_gat import edge_dots_least_s
from spmm_bench.program_spans import entries


def read(rec):
    calls = [e for e in entries("flex.edge_dots") if e["device_s"] > 0]
    if not calls:
        return None
    least = sum(e["count"] * edge_dots_least_s(rec["m"], rec["n"],
                                               e["attrs"]["nnz"],
                                               e["attrs"]["k"])
                for e in calls)
    return least / sum(e["device_s"] for e in calls) * 100
