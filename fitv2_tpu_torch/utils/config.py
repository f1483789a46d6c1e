"""YAML configs: left-to-right merge and model instantiation.

Counterpart of fitv2_tpu/utils/config.py for the port: the same YAML files
load with pyyaml (deep merge, right wins; ``${tuple:a, b}`` values resolve
to tuples), and ``config_to_model`` builds the port's model from a
``network_config`` whose target names a model of the reference, of the JAX
package or of the port: the FiT, FiTLwD, the shared-encoder FiTLwD and BFM.
``get_obj_from_str`` / ``instantiate_from_config`` resolve any target to
the port's counterpart (``resolve_target``).
"""

from __future__ import annotations

import importlib
import inspect
import warnings
from typing import Any, Mapping, Sequence

import yaml

# every network target a config may name -- the reference's (the
# published YAMLs, as in the JAX package's REFERENCE_TARGET_MAP,
# fitv2_tpu/utils/config.py), the JAX package's and the port's -- and the
# port's (module, builder, class whose keyword arguments a config may set)
_FIT = ('fit', 'FiT', 'FiT')
_LWD = ('fit_lwd', 'FiTLwD', 'FiTLwD')
_SHARED = ('fit_lwd_sharedenc', 'FiTLwDSharedEncSepDec',
           'FiTLwDSharedEncSepDec')
_BFM = ('bfm', 'BFM', 'FiTLwDSharedEncSepDec')
MODEL_TARGETS = {
    'fit.model.fit_model.FiT': _FIT,
    'fitv2_tpu.models.fit.FiT': _FIT,
    'fitv2_tpu_torch.models.fit.FiT': _FIT,
    'fit.model.fit_model_lwd.FiTLwD': _LWD,
    'fitv2_tpu.models.fit_lwd.FiTLwD': _LWD,
    'fitv2_tpu_torch.models.fit_lwd.FiTLwD': _LWD,
    'fit.model.fit_model_lwd.FiTLwD_sharedenc_sepdec': _SHARED,
    'fit.model.fit_model_lwd_bk.FiTLwD_sharedenc_sepdec': _SHARED,
    'fitv2_tpu.models.fit_lwd_sharedenc.FiTLwDSharedEncSepDec': _SHARED,
    'fitv2_tpu_torch.models.fit_lwd_sharedenc.FiTLwDSharedEncSepDec':
        _SHARED,
    'fit.model.bfm.FiT': _BFM,
    'fitv2_tpu.models.bfm.BFM': _BFM,
    'fitv2_tpu_torch.models.bfm.BFM': _BFM,
}
# the targets that build the port's FiT
FIT_TARGETS = tuple(t for t, m in MODEL_TARGETS.items() if m is _FIT)
# the other targets a config may name (the reference's and the JAX
# package's) -> the port's counterpart
_LOADER = 'fitv2_tpu_torch.data.latent_dataset.INLatentLoader'
OTHER_TARGETS = {
    'fit.data.in1k_latent_dataset.INLatentLoader': _LOADER,
    'fitv2_tpu.data.latent_dataset.INLatentLoader': _LOADER,
}
# packages of the JAX world, never imported by the port
_JAX_PACKAGES = ('fitv2_tpu', 'jax', 'flax', 'optax')

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


def resolve_target(target: str) -> str:
    """The port's dotted path for a config target: a model target (any in
    ``MODEL_TARGETS``) -> the function that builds it, a mapped target ->
    its counterpart, a ``fitv2_tpu.`` path -> the same path under
    ``fitv2_tpu_torch.`` where the port has it; any other target is
    returned as it is. A target of the JAX world without a counterpart
    raises ``NotImplementedError``; the JAX package is never imported."""
    if target in MODEL_TARGETS:
        module, build, _ = MODEL_TARGETS[target]
        return f'fitv2_tpu_torch.models.{module}.{build}'
    if target in OTHER_TARGETS:
        return OTHER_TARGETS[target]
    root = target.split('.', 1)[0]
    if root not in _JAX_PACKAGES:
        return target
    if root == 'fitv2_tpu':
        candidate = 'fitv2_tpu_torch' + target[len('fitv2_tpu'):]
        module, _, name = candidate.rpartition('.')
        try:
            if hasattr(importlib.import_module(module), name):
                return candidate
        except ImportError:
            pass
    raise NotImplementedError(f'config target {target!r} has no counterpart '
                              'in the PyTorch port')


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    """The object a dotted config target names, resolved to the port's
    counterpart (``resolve_target``)."""
    module, name = resolve_target(string).rsplit('.', 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, name)


def instantiate_from_config(config: Mapping[str, Any], **extra) -> Any:
    """{'target': 'pkg.mod.Cls', 'params': {...}} -> Cls(**params,
    **extra), with the target resolved to the port's counterpart; the
    reference's '__is_first_stage__' / '__is_unconditional__' give None."""
    if 'target' not in config:
        if config in ('__is_first_stage__', '__is_unconditional__'):
            return None
        raise KeyError('Expected key `target` to instantiate.')
    params = dict(config.get('params') or {})
    params.update(extra)
    return get_obj_from_str(config['target'])(**params)


def _init_params(cls) -> set:
    """The keyword arguments ``cls(...)`` takes, along its class chain."""
    names = set()
    for klass in cls.__mro__:
        if '__init__' in vars(klass) and klass.__module__.startswith(
                'fitv2_tpu_torch.'):
            names |= set(inspect.signature(klass.__init__).parameters)
    return names - {'self', 'kwargs'}


def config_to_model(network_config: Mapping[str, Any], **overrides):
    """The port's model from a reference-style ``network_config``; params
    the model does not take are dropped with a warning."""
    target = network_config.get('target')
    if target not in MODEL_TARGETS:
        raise NotImplementedError(
            f'network target {target!r} is not ported yet (the PyTorch port '
            f'builds {sorted(MODEL_TARGETS)})')
    module, builder, cls_name = MODEL_TARGETS[target]
    module = importlib.import_module(f'fitv2_tpu_torch.models.{module}')
    build = getattr(module, builder)
    cls = getattr(importlib.import_module(
        'fitv2_tpu_torch.models'), cls_name)
    params = {k: v for k, v in dict(network_config.get('params') or {}).items()
              if k not in _DROPPED_KEYS}
    accepted = _init_params(cls)
    unknown = set(params) - accepted
    if unknown:
        warnings.warn(f'config_to_model: dropping unknown params '
                      f'{sorted(unknown)} for {target}')
    params = {k: v for k, v in params.items() if k in accepted}
    params.update(overrides)
    return build(**params)
