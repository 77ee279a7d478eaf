"""Distributed execution of the model stack: logical-axis sharding, a
mesh of positions (devices may repeat), placement of trees of tensors
and the collectives over a named axis (``sharding``)."""

from repro_torch.dist.sharding import (RULES_2D, RULES_3D, Blocks, Mesh,
                                       NamedSharding, P, RowSplit, Sharded,
                                       abstract_mesh, all_gather,
                                       current_mesh, current_rules,
                                       device_put, gather, held_bytes,
                                       make_mesh, place, pmax, pmean, psum,
                                       reduce_scatter, shard,
                                       shard_activation_sp, sp_rules, spec,
                                       tree_map2, use_mesh, zeros)

__all__ = ["RULES_2D", "RULES_3D", "Blocks", "Mesh", "NamedSharding", "P",
           "RowSplit", "Sharded", "abstract_mesh", "all_gather",
           "current_mesh", "current_rules", "device_put", "gather",
           "held_bytes", "make_mesh", "place", "pmax", "pmean", "psum",
           "reduce_scatter", "shard", "shard_activation_sp", "sp_rules",
           "spec", "tree_map2", "use_mesh", "zeros"]
