from flex_tpu_torch.io.csv_loader import make_features
from flex_tpu_torch.io.synth import (
    banded_graph, bipartite_projection_graph, community_graph, reddit_posts,
    rmat_graph, uniform_graph,
)

__all__ = [
    "make_features", "banded_graph", "bipartite_projection_graph",
    "community_graph", "reddit_posts", "rmat_graph", "uniform_graph",
]
