"""Carry FiT weights across from the JAX package to this one.

``state_dict_from_jax`` maps a JAX/flax FiT parameter tree (numpy leaves,
per-block tensors stacked along a leading depth axis under
``blocks/block/``, or per-block ``blocks_{i}/`` subtrees) onto
``fitv2_tpu_torch.models.FiT.state_dict()``. The port's parameter names are
the flax names joined with '.', so the map is: unstack the blocks, rename
``kernel`` -> ``weight`` and transpose it (flax Dense kernels are (in, out),
``nn.Linear`` weights (out, in)).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ''
             ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(path: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    parts = path.split('/')
    if parts[-1] == 'kernel':
        parts[-1] = 'weight'
        value = np.swapaxes(value, -1, -2)
    return '.'.join(parts), torch.from_numpy(
        np.array(value, dtype=np.float32, order='C'))


def state_dict_from_jax(params_np: Mapping[str, Any], *, depth: int,
                        num_heads: int, adaln_type: str,
                        rope_layout: str = 'split') -> Dict[str, torch.Tensor]:
    """JAX FiT params -> this package's FiT state_dict (float32 tensors).

    ``rope_layout`` is the layout of the JAX model the params come from; the
    port's FiT must be built with the same layout, because the q/k basis of
    the qkv projection carries over unpermuted. ``num_heads`` and
    ``adaln_type`` are checked against the tree.
    """
    flat = _flatten(params_np.get('params', params_np))
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        if path.startswith('blocks/block/'):
            if value.shape[0] != depth:
                raise ValueError(f'{path}: stacked depth {value.shape[0]} '
                                 f'!= depth {depth}')
            rest = path[len('blocks/block/'):]
            for i in range(depth):
                name, t = _leaf(f'blocks/{i}/{rest}', value[i])
                sd[name] = t
        else:
            m = re.match(r'blocks_(\d+)/(.*)', path)
            name, t = _leaf(f'blocks/{m[1]}/{m[2]}' if m else path, value)
            sd[name] = t

    qkv = sd.get('blocks.0.attn.qkv.weight')
    if qkv is not None:
        c = qkv.shape[1]
        if qkv.shape[0] != 3 * c or c % num_heads:
            raise ValueError(f'qkv {tuple(qkv.shape)} does not split into '
                             f'{num_heads} heads')
        if rope_layout == 'split' and (c // num_heads // 2) % 2:
            raise ValueError('split RoPE needs an even per-axis rope dim')
    lora = 'blocks.0.adaLN_modulation.fc1.weight' in sd
    if depth and lora != (adaln_type == 'lora'):
        raise ValueError(f'adaln_type={adaln_type!r} does not match the '
                         'adaLN parameters in the tree')
    return sd
