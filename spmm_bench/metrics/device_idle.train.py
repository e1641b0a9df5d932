"""The device's idle share of the traced window, in %."""
from spmm_bench.trace import idle_pct as read  # noqa: F401
