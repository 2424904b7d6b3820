# Distribution substrate: logical-axis sharding rules with divisibility-
# aware fallback, the per-rank shards they give, the collectives of the
# mesh (with the int8 ring all-reduce) and GPipe pipeline stages.
from .sharding import (DEFAULT_RULES, gather, local_shard, logical_spec,
                       placements, shard_fit, tree_specs)
