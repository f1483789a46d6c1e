"""Inline evaluation during training: an EMA preview batch and its FID.

Counterpart of fitv2_tpu/train/eval_hook.py: every ``every`` steps, the
EMA weights are copied into the hook's own sampling model (a copy of the
model it is given: it writes no weight of the run), a preview batch is sampled
with the port's ``build_sampler`` and written as ``preview_{step}.npz``
by process 0, and, with a reference npz and a VAE, the batch's FID and
Inception score against it join the step's metrics (``inline_fid``,
``inline_is``), all without leaving the training process.

Usage:
    hook = InlineEvalHook(trainer.one_process_model, sample_cfg,
                          every=5000, ref_images='ref.npz', vae=vae,
                          out_dir='previews', device=trainer.device)
    hook.attach(trainer.gathered_ema)
    trainer.train(metric_hook=hook)  # the hook also receives the metrics

Under data parallelism or model sharding every process runs the hook at
the same steps (``gathered_ema`` is a collective there) and samples the
same images from the same draws; process 0 alone writes the preview and
computes the FID and the Inception score (it alone loads the Inception
network and the reference), so only its metrics carry them. The sampling
model is never a sharded module: ``Trainer.one_process_model`` is the
model's structure taken before the trainer shards it.

The labels and the noise come from a CPU generator seeded from (seed,
step) (``trainer.step_generator``), so a preview does not depend on the
device; JAX draws them from ``fold_in(PRNGKey(seed), step)``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from fitv2_tpu_torch.parallel.mesh import process_index
from fitv2_tpu_torch.sample.pipeline import SamplingConfig, build_sampler
from fitv2_tpu_torch.train.trainer import step_generator

logger = logging.getLogger('fitv2_tpu_torch.eval_hook')


@dataclasses.dataclass
class InlineEvalHook:
    """``model``: the FiT whose structure, dtype and device the preview
    samples with (one process's; its parameters may lie on the meta
    device, as ``Trainer.one_process_model``'s do, and ``device`` then
    says where to sample). ``attach`` copies it once, and each evaluation
    copies the EMA weights into that copy: ``model`` itself is never
    written (an fp32 trainer's model holds the master parameters);
    ``vae``: the port's
    AutoencoderKL (the preview is then uint8 images, else latents);
    ``ref_images``: an npz (arr_0 uint8) the FID is taken against;
    ``inception_weights``, ``weights_are_adm``: the Evaluator's."""
    model: Any
    sample_cfg: SamplingConfig
    every: int = 5000
    ref_images: Optional[str] = None
    inception_weights: Optional[str] = None
    weights_are_adm: bool = False
    vae: Any = None
    out_dir: Optional[str] = None
    seed: int = 0
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self._evaluator = None
        self._ref_acts = None
        self._sampler = None
        self._sample_model = None
        self._get_ema: Optional[Callable[[], Dict[str, torch.Tensor]]] = None

    def attach(self, get_ema_params: Callable[[], Dict[str, torch.Tensor]]
               ) -> 'InlineEvalHook':
        """``get_ema_params()`` -> the current EMA parameters by name
        (called at each evaluation). Makes the hook's sampling model, a
        copy of ``model`` with parameters of its own, uninitialised and
        without gradients."""
        from fitv2_tpu_torch.parallel.sharding import is_sharded
        if is_sharded(self.model):
            raise ValueError('InlineEvalHook: the model is sharded; give '
                             'the hook Trainer.one_process_model')
        memo = {id(p): torch.nn.Parameter(torch.empty(
            p.shape, dtype=p.dtype, device=self.device or p.device),
            requires_grad=False) for p in self.model.parameters()}
        self._get_ema = get_ema_params
        self._sample_model = copy.deepcopy(self.model, memo)
        self._sampler = None
        return self

    def draw(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The preview's labels (B,) and noise z (B, context, p*p*C), from
        the CPU generator of (seed, step)."""
        cfg, m = self.sample_cfg, self.model
        gen = step_generator(self.seed, step)
        labels = torch.randint(0, cfg.num_classes, (cfg.per_device_batch,),
                               generator=gen)
        z = torch.randn((cfg.per_device_batch, m.context_size,
                         m.patch_size ** 2 * m.in_channels), generator=gen)
        return labels, z

    def _ensure_eval(self) -> None:
        if self._evaluator is None and self.ref_images is not None:
            from fitv2_tpu_torch.eval.evaluator import Evaluator
            device = next(self._sample_model.parameters()).device
            self._evaluator = Evaluator(
                self.inception_weights, weights_are_adm=self.weights_are_adm,
                device=device)
            self._ref_acts = self._evaluator.read_activations(self.ref_images)

    def __call__(self, step: int, train_metrics: Dict[str, float]) -> None:
        if step % self.every != 0:
            return
        if self._get_ema is None:
            raise RuntimeError('InlineEvalHook: attach() the EMA first')
        ema = self._get_ema()
        with torch.no_grad():
            for name, p in self._sample_model.named_parameters():
                p.copy_(ema[name])
        if self._sampler is None:
            self._sampler = build_sampler(self._sample_model, self.sample_cfg,
                                          self.vae)
        labels, z = self.draw(step)
        images = self._sampler(labels, z=z).cpu().numpy()
        if process_index() != 0:
            return
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            np.savez(os.path.join(self.out_dir, f'preview_{step}.npz'),
                     arr_0=images)
        self._ensure_eval()
        if self._evaluator is not None and images.dtype == np.uint8:
            from fitv2_tpu_torch.eval import statistics as stats
            acts = self._evaluator.read_activations(images)
            fid = stats.fid_from_activations(self._ref_acts['pool3'],
                                             acts['pool3'])
            is_score = stats.inception_score(acts['softmax'])
            note = ('' if self._evaluator.comparable_to_published
                    else ' [non-ADM weights: not comparable to published]')
            logger.info('inline eval step %d: fid=%.3f is=%.3f%s',
                        step, fid, is_score, note)
            train_metrics['inline_fid'] = fid
            train_metrics['inline_is'] = is_score
