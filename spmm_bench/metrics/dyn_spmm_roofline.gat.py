"""The GAT step's dynamic-value SpMMs (kernel 7 forward and on the
transposed tables, ``flex.spmm`` spans) against their least time, from
the program's spans, in %."""
from spmm_bench.program_spans import step_spmm_roofline as read  # noqa: F401
