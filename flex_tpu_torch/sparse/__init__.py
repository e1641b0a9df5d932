from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR
from flex_tpu_torch.sparse.perm import apply_vertex_order, invert_permutation

__all__ = ["CSRGraph", "DeviceCSR", "apply_vertex_order", "invert_permutation"]
