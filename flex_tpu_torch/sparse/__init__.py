from flex_tpu_torch.sparse.csr import CSRGraph, GraphStats
from flex_tpu_torch.sparse.device import DeviceCSR
from flex_tpu_torch.sparse.perm import (
    apply_vertex_order, check_permutation_invariants, invert_permutation,
)

__all__ = ["CSRGraph", "GraphStats", "DeviceCSR", "apply_vertex_order",
           "check_permutation_invariants", "invert_permutation"]
