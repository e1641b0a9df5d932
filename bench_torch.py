#!/usr/bin/env python3
"""The headline benchmark on the PyTorch/CUDA port (one NVIDIA card).

    python3 bench_torch.py

Prints exactly one JSON line on stdout (``metric``, ``value`` in GF/s,
``vs_baseline``, tPre, tElap, the method the autotuner chose, err_frac,
the ratio to the time model, the secondary ELL row and the card), all
progress on stderr; exit status 1 when the result check failed.  See
``flex_tpu_torch/bench/headline.py``.
"""
import sys

from flex_tpu_torch.bench.headline import main

if __name__ == "__main__":
    sys.exit(main())
