"""The mean host microseconds of a plan call, from the program's
spans."""
from spmm_bench.program_spans import spmm_host_us as read  # noqa: F401
