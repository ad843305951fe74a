"""Distributed runtime pieces of the port: fleet dispatch over a mesh of
devices (``MeshInfo``, ``fleet_pad``, ``make_fleet_batch_fn``), the
posit-compressed collectives on ``torch.distributed``
(``distributed.collectives``), and fault tolerance with the elastic
re-mesh; and the production meshes' layout rules for the dry run
(``distributed.rules``, on ``sharding``'s ``PartitionSpec``,
``NamedSharding``, ``logical_spec``, ``shard_leaf`` and ``replicated``)."""
from .fault_tolerance import (ElasticConfig, RestartPolicy,  # noqa: F401
                              StepWatchdog, largest_valid_mesh, remesh,
                              run_with_restarts)
from .sharding import (MeshInfo, NamedSharding, PartitionSpec,  # noqa: F401
                       fleet_pad, logical_spec, make_fleet_batch_fn,
                       replicated, shard_leaf)
