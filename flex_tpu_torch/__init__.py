"""flex_tpu_torch — the windowed-hybrid SpMM of ``flex_tpu``, and GCN
training on it, in PyTorch and CUDA for an NVIDIA H100.

  C[m, k] = A[m, n] @ B[n, k]      A sparse (graph adjacency, CSR), B dense.

The module layout mirrors ``flex_tpu``; this package imports neither JAX
nor ``flex_tpu``.  Host layers (``sparse.csr``, ``sparse.perm``, ``io``,
``reorder``, ``utils.check``, ``ops.ref``, the window selection) are
NumPy copies; format builds and products run on a torch device, CUDA
unless the caller passes ``device="cpu"``.

- :mod:`flex_tpu_torch.ops.window_spmm` — windowed hybrid, differentiable
  in B and in A's values; its dense half is the hand-written kernel
  ``csrc/window_spmm.cu``, its two gradients ``csrc/window_spmm_bwd.cu``.
- :mod:`flex_tpu_torch.ops.ell_spmm` — ELL (the residue), with the
  transposed-pattern backward for training.
- :mod:`flex_tpu_torch.ops.gcn`, :mod:`flex_tpu_torch.models` — GCN layer,
  the 2-layer GCN and its train step.
- :mod:`flex_tpu_torch.kernels` — nvcc build + ctypes loader.
- :mod:`flex_tpu_torch.convert` — JAX plan arrays → port plans.
- :mod:`flex_tpu_torch.bench.harness` — tPre / tElap / GF/s on the card.
"""

from flex_tpu_torch.ops import spmm  # noqa: F401
from flex_tpu_torch.ops.ell_spmm import prepare_ell, with_bwd_plan  # noqa: F401
from flex_tpu_torch.ops.gcn import gcn_layer, pick_association  # noqa: F401
from flex_tpu_torch.ops.window_spmm import (  # noqa: F401
    prepare_windowed, with_training_bwd,
)
from flex_tpu_torch.sparse.csr import CSRGraph  # noqa: F401
from flex_tpu_torch.sparse.device import DeviceCSR  # noqa: F401
