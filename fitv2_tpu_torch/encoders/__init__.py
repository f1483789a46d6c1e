"""Frozen representation encoders for REPA alignment.

Counterpart of fitv2_tpu/encoders: the teachers whose features the LwD
REPA loss aligns to (``repa_target`` in the latent shards), from a local
torch state dict or a seeded random initialisation (nothing is
downloaded), with each family's input normalisation
(``preprocess_raw_image``). Families: dinov2 (encoders/dinov2.py), clip
(encoders/clip.py) and the generic pre-norm ViT of dinov1 / mae / jepa /
mocov3 (encoders/vit.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from fitv2_tpu_torch.encoders.clip import (
    CLIPVisionTransformer, clip_vit_b16, clip_vit_l14,
    convert_clip_visual_state_dict)
from fitv2_tpu_torch.encoders.dinov2 import (
    DinoV2ViT, convert_dinov2_state_dict, dinov2_vitb14, dinov2_vitg14,
    dinov2_vitl14, dinov2_vits14, resize_cubic)
from fitv2_tpu_torch.encoders.vit import (
    VisionTransformer, ViTBlock, convert_vit_state_dict, vit_base, vit_huge,
    vit_large)

Tensor = torch.Tensor

# (mean, std) in [0, 1] space, per encoder family
_IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
_CLIP = ((0.48145466, 0.4578275, 0.40821073),
         (0.26862954, 0.26130258, 0.27577711))
_PREPROC = {'dinov2': _IMAGENET, 'dinov1': _IMAGENET, 'mae': _IMAGENET,
            'jepa': _IMAGENET, 'mocov3': _IMAGENET, 'clip': _CLIP}
_VIT_ARCHS = {'vit_base': vit_base, 'vit_large': vit_large,
              'vit_huge': vit_huge}
_DINOV2_ARCHS = {'vit_small': dinov2_vits14, 'vit_base': dinov2_vitb14,
                 'vit_large': dinov2_vitl14, 'vit_giant': dinov2_vitg14}


def preprocess_raw_image(x: Tensor, enc_type: str) -> Tensor:
    """uint8 / float [0, 255] NHWC -> the family's normalised float32
    NHWC (ImageNet's mean and std unless the family is clip)."""
    mean, std = _PREPROC.get(enc_type.split('-')[0], _IMAGENET)
    x = x.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def load_encoders(enc_type: str, weights_path: Optional[str] = None,
                  arch: str = 'vit_base', seed: int = 0
                  ) -> Tuple[nn.Module, Callable[[Tensor], Tensor]]:
    """(the frozen teacher in eval mode on the CPU, its preprocess_fn).

    ``enc_type``'s family (the part before the first '-') picks the
    architecture: dinov2 (``arch`` vit_small / base / large / giant), clip
    (ViT-L/14 for ``arch`` vit_large or clip_vit_l14, else ViT-B/16) or the
    generic ViT (vit_base / large / huge). ``weights_path``: a local torch
    state dict (torch hub / timm / I-JEPA naming, or an OpenAI CLIP
    checkpoint); without one the weights are a random initialisation
    seeded with ``seed``, for pipeline runs only."""
    family = enc_type.split('-')[0]
    sd = None
    if weights_path is not None:
        from fitv2_tpu_torch.ckpt.torch_import import load_torch_state_dict
        sd = load_torch_state_dict(weights_path)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if family == 'dinov2':
            registers = (sd['register_tokens'].shape[1]
                         if sd is not None and 'register_tokens' in sd else 0)
            model = _DINOV2_ARCHS.get(arch, dinov2_vitb14)(
                num_register_tokens=registers)
            convert = convert_dinov2_state_dict
        elif family == 'clip':
            model = (clip_vit_l14() if arch in ('vit_large', 'clip_vit_l14')
                     else clip_vit_b16())
            convert = convert_clip_visual_state_dict
        else:
            model = _VIT_ARCHS[arch]()
            convert = convert_vit_state_dict
    if sd is not None:
        model.load_state_dict(convert(sd))
    model.eval().requires_grad_(False)
    return model, lambda x: preprocess_raw_image(x, enc_type)


__all__ = ['CLIPVisionTransformer', 'DinoV2ViT', 'VisionTransformer',
           'ViTBlock', 'convert_clip_visual_state_dict',
           'convert_dinov2_state_dict', 'convert_vit_state_dict',
           'load_encoders', 'preprocess_raw_image', 'resize_cubic',
           'vit_base', 'vit_huge', 'vit_large']
