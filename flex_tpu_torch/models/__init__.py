from flex_tpu_torch.models.gat import (
    GAT, gat_loss, make_gat_train_step, prepare_attention,
)
from flex_tpu_torch.models.gcn import GCN, gcn_loss, make_train_step
from flex_tpu_torch.models.sage import (
    GraphSAGE, make_sage_train_step, sage_loss,
)

__all__ = ["GCN", "gcn_loss", "make_train_step",
           "GraphSAGE", "sage_loss", "make_sage_train_step",
           "GAT", "gat_loss", "make_gat_train_step", "prepare_attention"]
