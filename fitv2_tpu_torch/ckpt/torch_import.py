"""Load published (reference-layout) PyTorch FiT/FiTv2 checkpoints.

Counterpart of fitv2_tpu/ckpt/torch_import.py. Loads ``.safetensors`` or
``.bin``/``.pt`` state dicts, strips ``_orig_mod.``/``module.``/``model.``
prefixes, drops ignored keys, and maps reference parameter names onto this
package's FiT:

  reference name                            port name
  --------------                            ---------
  t_embedder.mlp.{0,2}.*                    t_embedder.mlp_{0,2}.*
  y_embedder.embedding_table.weight         y_embedder.embedding_table
  global_adaLN_modulation.1.*               global_adaLN_modulation.fc_out.*
  blocks.N.mlp.fc1_g + fc1_x                blocks.N.mlp.fc1 (rows [g | x])
  blocks.N.adaLN_modulation.1.* (normal)    blocks.N.adaLN_modulation.fc_out.*
  blocks.N.adaLN_modulation.{1,2}.* (lora)  blocks.N.adaLN_modulation.{fc1,fc_out}.*
  final_layer.adaLN_modulation.1.*          final_layer.adaLN_modulation.fc_out.*

Every other name is the same. With ``rope_layout='split'`` (the port's
default) the q and k rows of every qkv projection, and any q/k norm
weights, are permuted per head into the split-RoPE basis, which leaves the
attention output unchanged.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch

from fitv2_tpu_torch.models.rope import split_permutation

Tensor = torch.Tensor


def load_torch_state_dict(path: str) -> Dict[str, Tensor]:
    """A .safetensors or torch .bin/.pt state dict, as CPU tensors."""
    if path.endswith('.safetensors'):
        from safetensors.torch import load_file
        return load_file(path, device='cpu')
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return dict(sd)


def _strip_prefixes(sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    out = {}
    for k, v in sd.items():
        for pref in ('_orig_mod.', 'module.', 'model.'):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


def _adaln_renames(adaln_type: str) -> Dict[str, str]:
    if adaln_type == 'lora':
        return {'1': 'fc1', '2': 'fc_out'}
    if adaln_type == 'swiglu':
        return {n: n for n in ('fc1_g', 'fc1_x', 'fc2')}
    return {'1': 'fc_out'}


def _split_layout_permute(sd: Dict[str, Tensor], num_heads: int) -> None:
    """Permute q/k rows of every qkv projection into the split basis."""
    for name in [k for k in sd if k.endswith('attn.qkv.weight')]:
        c = sd[name].shape[0] // 3
        dh = c // num_heads
        perm = torch.as_tensor(split_permutation(dh))
        idx = torch.arange(c).view(num_heads, dh)[:, perm].reshape(-1)
        idx = torch.cat([idx, idx + c, torch.arange(2 * c, 3 * c)])
        base = name[:-len('qkv.weight')]
        for key in (name, base + 'qkv.bias'):
            if key in sd:
                sd[key] = sd[key][idx].contiguous()
        for key in (base + 'q_norm.weight', base + 'k_norm.weight'):
            if key in sd:
                sd[key] = sd[key][perm].contiguous()


def convert_fit_state_dict(sd: Dict[str, Tensor], *, depth: int,
                           adaln_type: str = 'normal',
                           num_heads: Optional[int] = None,
                           rope_layout: str = 'split',
                           ignore_keys: Optional[List[str]] = None,
                           strict: bool = True) -> Dict[str, Tensor]:
    """Reference-named state dict -> this package's FiT state_dict."""
    sd = _strip_prefixes(sd)
    if ignore_keys:
        pats = [re.compile(p) for p in ignore_keys]
        sd = {k: v for k, v in sd.items()
              if not any(p.search(k) for p in pats)}
    sd = {k: v for k, v in sd.items() if not k.startswith('rel_pos_embed.')
          and '.attn.rel_pos_embed' not in k}

    out: Dict[str, Tensor] = {}

    def move(src: str, dst: str) -> None:
        for suffix in ('.weight', '.bias'):
            if src + suffix in sd:
                out[dst + suffix] = sd.pop(src + suffix)

    move('x_embedder.proj', 'x_embedder.proj')
    move('t_embedder.mlp.0', 't_embedder.mlp_0')
    move('t_embedder.mlp.2', 't_embedder.mlp_2')
    if 'y_embedder.embedding_table.weight' in sd:
        out['y_embedder.embedding_table'] = sd.pop(
            'y_embedder.embedding_table.weight')
    move('global_adaLN_modulation.1', 'global_adaLN_modulation.fc_out')
    for i in range(depth):
        pre = f'blocks.{i}'
        for n in ('attn.qkv', 'attn.proj', 'attn.q_norm', 'attn.k_norm',
                  'norm1', 'norm2', 'mlp.fc1', 'mlp.fc2'):
            move(f'{pre}.{n}', f'{pre}.{n}')
        # timm SwiGLU fc1_g / fc1_x -> one fc1 with output rows [g | x]
        for suffix in ('.weight', '.bias'):
            g = sd.pop(f'{pre}.mlp.fc1_g{suffix}', None)
            if g is not None:
                out[f'{pre}.mlp.fc1{suffix}'] = torch.cat(
                    [g, sd.pop(f'{pre}.mlp.fc1_x{suffix}')], dim=0)
        for src, dst in _adaln_renames(adaln_type).items():
            move(f'{pre}.adaLN_modulation.{src}',
                 f'{pre}.adaLN_modulation.{dst}')
    move('final_layer.linear', 'final_layer.linear')
    move('final_layer.norm_final', 'final_layer.norm_final')
    fl_type = 'swiglu' if adaln_type == 'swiglu' else 'normal'
    for src, dst in _adaln_renames(fl_type).items():
        move(f'final_layer.adaLN_modulation.{src}',
             f'final_layer.adaLN_modulation.{dst}')

    if sd and strict:
        raise ValueError(f'unconverted reference keys: {sorted(sd)[:10]}'
                         f'{"..." if len(sd) > 10 else ""}')
    if rope_layout == 'split':
        if num_heads is None:
            raise ValueError("rope_layout='split' conversion needs num_heads")
        _split_layout_permute(out, num_heads)
    return {k: v.float() for k, v in out.items()}


def load_fit_checkpoint(path: str, model, ignore_keys: Optional[List[str]]
                        = None):
    """Load a reference-layout checkpoint into a port FiT (strict)."""
    sd = convert_fit_state_dict(
        load_torch_state_dict(path), depth=model.depth,
        adaln_type=model.adaln_type, num_heads=model.num_heads,
        rope_layout=model.rope_layout, ignore_keys=ignore_keys)
    model.load_state_dict(sd, strict=True)
    return model
