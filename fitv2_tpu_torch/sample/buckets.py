"""Shape-bucketed sampling: one sampler per (H, W) bucket over one model.

Counterpart of fitv2_tpu/sample/buckets.py. Samplers are built lazily and
cached; every bucket runs the same module, so the weights live on the card
once (an int8 model's quantized weights too; each bucket keeps its own
activation scales). A bucket larger than the model's context pads its
tokens to the bucket's own length (``build_sampler(context_size=...)``),
and its RoPE config is replaced per bucket (``apply_rope_interpolation``).
The standard buckets cover the published evaluation grid: 256x256
pretrain, 160x320 / 320x320 extrapolation, 512x512 / 320x640 HR.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from fitv2_tpu_torch.models.grid_utils import pixels_to_tokens
from fitv2_tpu_torch.sample.pipeline import SamplingConfig, build_sampler

# (height, width) -> recommended interpolation for an XL model trained at
# 16x16 patches
STANDARD_BUCKETS: Dict[Tuple[int, int], str] = {
    (256, 256): 'no',
    (160, 320): 'ntkpro2',
    (320, 320): 'ntkpro2',
    (512, 512): 'dynntk',
    (320, 640): 'dynntk',
}


@dataclasses.dataclass
class BucketedSampler:
    """Lazy per-bucket sampler cache over one model.

    The cache key is (height, width, interpolation, steps, cfg_scale): an
    explicit interpolation gets its own sampler. (JAX's key leaves the
    interpolation out, so there a second mode for a cached bucket returns
    the first mode's sampler.)

    Over an int8 model each bucket's sampler calibrates at the bucket's
    shape (or binds ``quant_collections[(height, width)]``, e.g. JAX's
    per-bucket collections through ``ckpt.quant_state_from_jax``) and owns
    its activation scales, as JAX's per-bucket ``quant_calib`` does; the
    int8 weights are quantized once and shared.
    """
    model: torch.nn.Module
    base_config: SamplingConfig = SamplingConfig()
    vae: Optional[torch.nn.Module] = None
    ori_max_pe_len: int = 16
    quant_collections: Optional[
        Dict[Tuple[int, int], Dict[str, torch.Tensor]]] = None

    def __post_init__(self):
        self._cache: Dict[Tuple[int, int, str, int, float], Callable] = {}

    def config_for(self, height: int, width: int,
                   interpolation: Optional[str] = None) -> SamplingConfig:
        interp = interpolation or STANDARD_BUCKETS.get((height, width))
        if interp is None:
            n_h, n_w = pixels_to_tokens(height, width,
                                        self.model.patch_size)
            interp = 'no' if max(n_h, n_w) <= self.ori_max_pe_len \
                else 'dynntk'
        return dataclasses.replace(
            self.base_config, image_height=height, image_width=width,
            interpolation=interp,
            ori_max_pe_len=(None if interp == 'no' else self.ori_max_pe_len),
            decouple=interp != 'no')

    def get(self, height: int, width: int,
            interpolation: Optional[str] = None) -> Callable:
        cfg = self.config_for(height, width, interpolation)
        key = (height, width, cfg.interpolation, cfg.num_sampling_steps,
               cfg.cfg_scale)
        if key not in self._cache:
            n_h, n_w = pixels_to_tokens(height, width,
                                        self.model.patch_size)
            self._cache[key] = build_sampler(
                self.model, cfg, self.vae,
                quant_collections=(self.quant_collections or {}).get(
                    (height, width)),
                context_size=max(self.model.context_size, n_h * n_w),
                prequantize=not self._cache)
        return self._cache[key]

    def sample(self, labels: torch.Tensor, height: int, width: int,
               interpolation: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.get(height, width, interpolation)(labels, generator, z)
