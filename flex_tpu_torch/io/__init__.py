from flex_tpu_torch.io.csv_loader import make_features
from flex_tpu_torch.io.synth import (
    bipartite_projection_graph, community_graph, reddit_posts,
)

__all__ = [
    "make_features", "bipartite_projection_graph", "community_graph",
    "reddit_posts",
]
