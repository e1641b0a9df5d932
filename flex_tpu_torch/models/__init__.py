from flex_tpu_torch.models.gcn import GCN, gcn_loss, make_train_step

__all__ = ["GCN", "gcn_loss", "make_train_step"]
