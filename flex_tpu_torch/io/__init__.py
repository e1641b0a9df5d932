from flex_tpu_torch.io.csv_loader import load_csv, make_features, save_csv
from flex_tpu_torch.io.synth import (
    amazon_like, amazon_posts, banded_graph, bipartite_projection_graph,
    community_graph, flickr_like, flickr_posts, hub_graph, ppi_comm, ppi_like,
    reddit_comm, reddit_like, reddit_posts, rmat_graph, uniform_graph,
    yelp_comm, yelp_like,
)

__all__ = [
    "load_csv", "save_csv", "make_features",
    "amazon_like", "amazon_posts", "banded_graph",
    "bipartite_projection_graph", "community_graph", "flickr_like",
    "flickr_posts", "hub_graph", "ppi_comm", "ppi_like", "reddit_comm",
    "reddit_like", "reddit_posts", "rmat_graph", "uniform_graph",
    "yelp_comm", "yelp_like",
]
