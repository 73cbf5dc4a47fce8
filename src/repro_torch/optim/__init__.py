from .optimizers import (Optimizer, sgd, adam, adamw, clip_by_global_norm,
                         tree_map, tree_leaves)

__all__ = ["Optimizer", "sgd", "adam", "adamw", "clip_by_global_norm",
           "tree_map", "tree_leaves"]
