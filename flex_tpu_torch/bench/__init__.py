from flex_tpu_torch.bench.harness import BenchResult, bench_spmm, sweep

__all__ = ["BenchResult", "bench_spmm", "sweep"]
