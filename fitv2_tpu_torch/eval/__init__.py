"""Evaluation: FID/sFID/IS/precision-recall + image statistics, and the
attention-map captures."""

from fitv2_tpu_torch.eval.attention_viz import (
    attention_rollout, collect_attention_maps, overlay_heatmap,
    run_with_attention, token_heatmap)
from fitv2_tpu_torch.eval.evaluator import (
    Evaluator, create_npz_from_sample_folder)
from fitv2_tpu_torch.eval.measure import measure_all
from fitv2_tpu_torch.eval.statistics import (
    activation_statistics, compute_all_metrics, fid_from_activations,
    frechet_distance, inception_score, precision_recall)

__all__ = [
    'attention_rollout', 'collect_attention_maps', 'overlay_heatmap',
    'run_with_attention', 'token_heatmap',
    'Evaluator', 'create_npz_from_sample_folder', 'activation_statistics',
    'compute_all_metrics', 'fid_from_activations', 'frechet_distance',
    'inception_score', 'measure_all', 'precision_recall',
]
