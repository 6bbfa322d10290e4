from . import launch
from .ensemble import ensemble
from .halo import HaloExchange, build_halo_exchange
from .scaling_model import halo_bytes_per_rhs, measure_exchange_rows
from .sharding import (
    make_sharded_cns_rhs,
    make_sharded_euler_rhs,
    make_sharded_rhs,
    partition_specs,
    shard_discretization,
)

__all__ = [
    "ensemble",
    "launch",
    "halo_bytes_per_rhs",
    "measure_exchange_rows",
    "HaloExchange",
    "build_halo_exchange",
    "make_sharded_cns_rhs",
    "make_sharded_euler_rhs",
    "make_sharded_rhs",
    "partition_specs",
    "shard_discretization",
]
