"""Data parallelism across processes (the mesh's data axis)."""

from fitv2_tpu_torch.parallel.mesh import (
    MeshConfig, all_reduce_mean_, broadcast_, build_mesh, collective_device,
    init_distributed, is_main_process, print0, process_allgather,
    process_count, process_index, row_shard_draws, sync_global_devices)

__all__ = [
    'MeshConfig', 'all_reduce_mean_', 'broadcast_', 'build_mesh',
    'collective_device', 'init_distributed', 'is_main_process', 'print0',
    'process_allgather', 'process_count', 'process_index',
    'row_shard_draws', 'sync_global_devices',
]
