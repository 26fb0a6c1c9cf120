"""Scale-out over ``torch.distributed``: one process per rank.

``launch.spawn`` starts the ranks; ``mesh`` holds the rank's view of the
group (``Mesh``), the sharding rules of the model's tables (``shard_model``)
and the deterministic collectives the sharded solves use.
"""
