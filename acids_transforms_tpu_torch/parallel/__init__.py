"""Multi-device scaling on ``torch.distributed`` (twin of the JAX
``parallel/``): mesh construction, batch sharding, and the sequence-parallel
STFT / ISTFT with a halo exchange between neighbouring ranks.

One process a device, started by ``torchrun`` (or the caller's
``init_process_group``); the mesh names the axes, batch sharding issues no
collective, and the halo exchange is point-to-point (NVLink P2P under NCCL,
gloo on the CPU).
"""
from .mesh import local_mesh, make_mesh
from .sharding import (
    data_parallel,
    sequence_parallel_istft,
    sequence_parallel_stft,
    shard_along,
    shard_map_batch,
)

__all__ = [
    "make_mesh",
    "local_mesh",
    "shard_along",
    "data_parallel",
    "shard_map_batch",
    "sequence_parallel_stft",
    "sequence_parallel_istft",
]
