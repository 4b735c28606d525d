from .sharding import (batch_pspecs, cache_pspecs, distribute_tree, named,
                       state_pspecs)

__all__ = ["batch_pspecs", "cache_pspecs", "state_pspecs", "named",
           "distribute_tree"]
