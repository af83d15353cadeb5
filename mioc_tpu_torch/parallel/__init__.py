"""Batch parallelism over starts and scenarios, the temporal DP, and the
multi-rank half on ``torch.distributed``: meshes of ranks, the level-sharded
DP build and the time-sharded temporal DP."""

from .device_mesh import make_device_mesh
from .batch import make_ode_trm_step, multistart_solve
from .shard_dp import build_tables_sharded
from .temporal import temporal_dp_solve, temporal_tables_sharded
from .multihost import init_multihost

__all__ = [
    "make_device_mesh",
    "make_ode_trm_step",
    "multistart_solve",
    "build_tables_sharded",
    "temporal_dp_solve",
    "temporal_tables_sharded",
    "init_multihost",
]
