from flex_tpu_torch.tiling.stats import TileStats, data_volume_est, tile_stats

__all__ = ["TileStats", "tile_stats", "data_volume_est"]
