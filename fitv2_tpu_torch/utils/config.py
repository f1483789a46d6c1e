"""YAML configs: left-to-right merge and model instantiation.

Counterpart of fitv2_tpu/utils/config.py for the port: the same YAML files
load with pyyaml (deep merge, right wins; ``${tuple:a, b}`` values resolve
to tuples), and ``config_to_model`` builds the port's FiT from a
``network_config`` whose target names the JAX FiT or the reference FiT.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Any, Mapping, Sequence

import yaml

# network targets that map onto the port's FiT
FIT_TARGETS = ('fitv2_tpu.models.fit.FiT', 'fit.model.fit_model.FiT',
               'fitv2_tpu_torch.models.fit.FiT')

# reference FiT kwargs with no model-side meaning here (checkpoint loading
# lives in fitv2_tpu_torch.ckpt); dropped silently as by the JAX package
_DROPPED_KEYS = {'abs_pos_embed', 'pretrain_ckpt', 'ignore_keys', 'finetune',
                 'overlap', 'global_cls'}


def deep_merge(base: dict, override: dict) -> dict:
    """Recursive right-wins merge of mappings."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_tuples(node: Any) -> Any:
    """'${tuple:a, b}' -> (a, b) with int/float parsing of the items."""
    if isinstance(node, dict):
        return {k: _resolve_tuples(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tuples(v) for v in node]
    if isinstance(node, str) and node.startswith('${tuple:'):
        items = []
        for part in node[len('${tuple:'):].rstrip('}').split(','):
            part = part.strip()
            for cast in (int, float):
                try:
                    part = cast(part)
                    break
                except ValueError:
                    pass
            items.append(part)
        return tuple(items)
    return node


def load_config(paths: Sequence[str] | str) -> dict:
    """Load YAML configs and merge them left to right into one dict."""
    if isinstance(paths, str):
        paths = [paths]
    merged: dict = {}
    for p in paths:
        with open(p) as f:
            merged = deep_merge(merged, yaml.safe_load(f) or {})
    return _resolve_tuples(merged)


def config_to_model(network_config: Mapping[str, Any], **overrides):
    """The port's FiT from a reference-style ``network_config``; params the
    FiT does not take are dropped with a warning."""
    from fitv2_tpu_torch.models.fit import FiT
    target = network_config.get('target')
    if target not in FIT_TARGETS:
        raise NotImplementedError(
            f'network target {target!r} is not ported yet (the PyTorch port '
            f'has the FiT family only: {FIT_TARGETS})')
    params = {k: v for k, v in dict(network_config.get('params') or {}).items()
              if k not in _DROPPED_KEYS}
    accepted = set(inspect.signature(FiT.__init__).parameters) - {'self'}
    unknown = set(params) - accepted
    if unknown:
        warnings.warn(f'config_to_model: dropping unknown params '
                      f'{sorted(unknown)} for {target}')
    params = {k: v for k, v in params.items() if k in accepted}
    params.update(overrides)
    return FiT(**params)
