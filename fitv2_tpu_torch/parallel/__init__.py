"""The mesh over the processes, model sharding and the GPipe pipeline
(JAX's fitv2_tpu.parallel, without ``hlo_check``)."""

from fitv2_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, SequenceShard, all_reduce_mean_, batch_sharding,
    broadcast_, build_mesh, collective_device, constrain_sequence,
    init_distributed, is_main_process, print0, process_allgather,
    process_count, process_index, row_shard_draws, sequence_sharding,
    sync_global_devices)
from fitv2_tpu_torch.parallel.pipeline import (
    make_pipelined_forward, pipeline_opt_shardings, pipeline_param_shardings)
from fitv2_tpu_torch.parallel.sharding import (
    ShardedLayout, fit_param_shardings, replicated, shard_model,
    shard_params)

__all__ = [
    'Mesh', 'MeshConfig', 'SequenceShard', 'ShardedLayout',
    'all_reduce_mean_', 'batch_sharding', 'broadcast_', 'build_mesh',
    'collective_device', 'constrain_sequence', 'fit_param_shardings',
    'init_distributed', 'is_main_process', 'make_pipelined_forward',
    'pipeline_opt_shardings', 'pipeline_param_shardings', 'print0',
    'process_allgather', 'process_count', 'process_index', 'replicated',
    'row_shard_draws', 'sequence_sharding', 'shard_model', 'shard_params',
    'sync_global_devices',
]
