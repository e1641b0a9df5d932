"""The host milliseconds of the set-up's plan builds, from the program's
spans."""
from spmm_bench.program_spans import plan_build_ms as read  # noqa: F401
