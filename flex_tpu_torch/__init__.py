"""flex_tpu_torch — the SpMM strategies of ``flex_tpu``, and GCN training
on the windowed hybrid, in PyTorch and CUDA for an NVIDIA H100.

  C[m, k] = A[m, n] @ B[n, k]      A sparse (graph adjacency, CSR), B dense.

The module layout mirrors ``flex_tpu``; this package imports neither JAX
nor ``flex_tpu``.  Host layers (``sparse.csr``, ``sparse.perm``, ``io``,
``reorder``, ``utils.check``, ``ops.ref``, the window selection) are
NumPy copies; format builds and products run on a torch device, CUDA
unless the caller passes ``device="cpu"``.

- :mod:`flex_tpu_torch.ops.window_spmm` — windowed hybrid, differentiable
  in B and in A's values; its dense half is the hand-written kernel
  ``csrc/window_spmm.cu``, its two gradients ``csrc/window_spmm_bwd.cu``.
  ``prepare_windowed(transposed=True)`` is the narrow-k variant
  (``csrc/window_spmm_t.cu``).
- :mod:`flex_tpu_torch.ops.ell_spmm` — ELL (the residue), with the
  transposed-pattern backward for training.
- :mod:`flex_tpu_torch.ops.pallas_band` — band, split and unsplit
  (``csrc/band_spmm.cu``, two kernels) and a plain-ops variant.
- :mod:`flex_tpu_torch.ops.gespmm` — GE-SpMM row chunks
  (``csrc/gespmm.cu``).
- :mod:`flex_tpu_torch.ops.xla_spmm`, :mod:`flex_tpu_torch.ops.bcoo_spmm`
  — the two baselines without a hand kernel: gather + scatter-add, and
  ``torch.sparse.mm`` on a CSR tensor.
- :mod:`flex_tpu_torch.ops.gcn`, :mod:`flex_tpu_torch.models` — GCN layer,
  the 2-layer GCN and its train step.
- :mod:`flex_tpu_torch.kernels` — nvcc build + ctypes loader.
- :mod:`flex_tpu_torch.convert` — JAX plan arrays → port plans.
- :mod:`flex_tpu_torch.bench` — the harness (tPre / tElap / GF/s on the
  card, sweep, CSV), the autotuner on the card's measured rates, the GCN
  layer bench.
- :mod:`flex_tpu_torch.cli` — ``python -m flex_tpu_torch <graph.csv> <k>``.
"""

from flex_tpu_torch.ops import spmm  # noqa: F401
from flex_tpu_torch.ops.bcoo_spmm import prepare_bcoo  # noqa: F401
from flex_tpu_torch.ops.ell_spmm import prepare_ell, with_bwd_plan  # noqa: F401
from flex_tpu_torch.ops.gcn import gcn_layer, pick_association  # noqa: F401
from flex_tpu_torch.ops.gespmm import prepare_gespmm  # noqa: F401
from flex_tpu_torch.ops.pallas_band import prepare_band  # noqa: F401
from flex_tpu_torch.ops.xla_spmm import prepare_xla  # noqa: F401
from flex_tpu_torch.ops.window_spmm import (  # noqa: F401
    prepare_windowed, with_training_bwd,
)
from flex_tpu_torch.sparse.csr import CSRGraph  # noqa: F401
from flex_tpu_torch.sparse.device import DeviceCSR  # noqa: F401
