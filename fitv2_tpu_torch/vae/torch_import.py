"""Weights for the port's VAE decoder.

The decoder's parameter names are diffusers' own, so a published diffusers
``AutoencoderKL`` state dict needs only: drop the encoder half (not ported
yet), rename the legacy attention names (query/key/value/proj_attn), and
flatten attention projections stored as 1x1 convolutions.
``state_dict_from_flax`` carries the JAX package's flax VAE parameters
across (the inverse of fitv2_tpu/vae/torch_import.py for the decode half).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from fitv2_tpu_torch.ckpt.convert import _flatten
from fitv2_tpu_torch.ckpt.torch_import import load_torch_state_dict

Tensor = torch.Tensor

_LEGACY_ATTN = {'query': 'to_q', 'key': 'to_k', 'value': 'to_v',
                'proj_attn': 'to_out.0'}


def convert_diffusers_state_dict(sd: Mapping[str, Tensor]
                                 ) -> Dict[str, Tensor]:
    """diffusers AutoencoderKL state dict -> the port's (decoder half)."""
    out: Dict[str, Tensor] = {}
    for k, v in sd.items():
        if not k.startswith(('decoder.', 'post_quant_conv.')):
            continue  # encoder / quant_conv: the encode half is not ported
        m = re.match(r'(.*\.attentions\.\d+)\.(query|key|value|proj_attn)'
                     r'\.(weight|bias)$', k)
        if m:
            k = f'{m[1]}.{_LEGACY_ATTN[m[2]]}.{m[3]}'
        if '.attentions.' in k and k.endswith('.weight') and v.dim() == 4:
            v = v[:, :, 0, 0]  # attention projection stored as a 1x1 conv
        out[k] = v.float()
    return out


def load_vae_state_dict(path: str) -> Dict[str, Tensor]:
    """A diffusers .safetensors/.bin VAE checkpoint -> the port's state dict."""
    return convert_diffusers_state_dict(load_torch_state_dict(path))


_FLAX_RENAMES = (
    (r'/(resnets|attentions)_(\d+)/', r'/\1/\2/'),
    (r'/up_(\d+)_resnets_(\d+)/', r'/up_blocks/\1/resnets/\2/'),
    (r'/up_(\d+)_upsample/', r'/up_blocks/\1/upsamplers/0/'),
    (r'/to_out/', r'/to_out/0/'),
    (r'/norm/scale$', r'/weight'),
    (r'/norm/bias$', r'/bias'),
)


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, Tensor]:
    """The JAX package's flax AutoencoderKL params -> the port's state dict
    (decoder half; flax conv kernels (kh, kw, I, O) -> (O, I, kh, kw), Dense
    kernels (I, O) -> (O, I))."""
    out: Dict[str, Tensor] = {}
    for path, v in _flatten(params.get('params', params)).items():
        if not path.startswith(('decoder/', 'post_quant_conv/')):
            continue
        path = '/' + path
        for pat, rep in _FLAX_RENAMES:
            path = re.sub(pat, rep, path)
        if path.endswith('/kernel'):
            path = path[:-len('kernel')] + 'weight'
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        out[path[1:].replace('/', '.')] = torch.from_numpy(
            np.array(v, dtype=np.float32, order='C'))
    return out
