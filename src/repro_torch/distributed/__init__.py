"""Distributed runtime pieces of the port: fleet dispatch over a mesh of
devices (``MeshInfo``, ``fleet_pad``, ``make_fleet_batch_fn``), the
posit-compressed collectives on ``torch.distributed``
(``distributed.collectives``), and fault tolerance with the elastic
re-mesh.  The reference's production-mesh layout rules (``rules.py``,
``logical_spec``, ``shard_leaf``) serve its 512-device dry run and land
with it (ROADMAP.md, queue A item A5b)."""
from .fault_tolerance import (ElasticConfig, RestartPolicy,  # noqa: F401
                              StepWatchdog, largest_valid_mesh, remesh,
                              run_with_restarts)
from .sharding import MeshInfo, fleet_pad, make_fleet_batch_fn  # noqa: F401
