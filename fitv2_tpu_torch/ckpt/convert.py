"""Carry FiT weights across from the JAX package to this one.

``state_dict_from_jax`` maps a JAX/flax FiT parameter tree (numpy leaves,
per-block tensors stacked along a leading depth axis under
``blocks/block/``, or per-block ``blocks_{i}/`` subtrees) onto
``fitv2_tpu_torch.models.FiT.state_dict()``. The port's parameter names are
the flax names joined with '.', so the map is: unstack the blocks, rename
``kernel`` -> ``weight`` and transpose it (flax Dense kernels are (in, out),
``nn.Linear`` weights (out, in)).

``lwd_state_from_jax`` does the same for the LwD family (FiTLwD and the
shared-encoder FiTLwD / BFM): each block stack (``segments_{i}``,
``rep_segments_{i}``, ``start_shared_blocks``, ``shared_rep_blocks``,
``mid_blocks``: ``.../stack/block/...`` leaves stacked along its own
length) is unstacked, and each per-segment list (``x_embedders_{i}``,
``t_embedders_{i}``, ``y_embedders_{i}``, ``final_layers_{i}``) becomes the
port's ``nn.ModuleList`` entry ``{name}.{i}``.

``inception_state_from_jax`` maps the JAX package's InceptionV3 parameters
(BatchNorm already folded; conv kernels (kh, kw, I, O)) onto
``fitv2_tpu_torch.eval.inception.InceptionV3.state_dict()`` (weights
(O, I, kh, kw)).

``train_state_from_jax`` carries a JAX ``TrainState`` (numpy leaves:
params, EMA, optax's adam mu / nu and counts, MultiSteps' accumulator)
onto the port's ``train.TrainState`` through the same parameter mapping.

``teacher_state_from_jax`` maps the JAX package's REPA teachers (ViT,
DINOv2, CLIP) onto ``fitv2_tpu_torch.encoders``' modules (torch hub /
OpenAI names).

``jax_leaves`` maps the other way, from a port model's parameters to the
JAX tree's leaves (a depth-stacked leaf holds one port parameter a block):
what the optimizers need to do per JAX leaf what optax does per leaf
(CAME's factored moments and RMS clip, the decay labels). Under model
sharding ``JaxLeaf.part`` is the piece of a leaf that one rank holds, and
which mesh axes split which of its axes.
``came_state_from_jax`` carries a JAX CAME state onto the port's ``CAME``.

``quant_state_from_jax`` carries the int8 serving mode's collections
(``quant_calib``: per-site activation absmax; ``quant_weights``: int8
kernels and per-channel scales) onto the port's ``Int8Linear`` buffers,
for ``fitv2_tpu_torch.kernels.quant.load_quant_state``;
``lwd_quant_state_from_jax`` does so over the LwD family's block stacks.

``disc_state_from_jax`` and ``lpips_state_from_jax`` map the JAX package's
PatchGAN discriminators (params and BatchNorm ``batch_stats``) and LPIPS
onto ``fitv2_tpu_torch.losses``' modules.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def _unstack_blocks(flat: Mapping[str, np.ndarray], depth: int
                    ) -> Dict[str, np.ndarray]:
    """Split ``blocks/block/...`` leaves stacked along depth into
    ``blocks/{i}/...`` and rename per-block ``blocks_{i}/...`` likewise."""
    out: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        if path.startswith('blocks/block/'):
            if value.shape[0] != depth:
                raise ValueError(f'{path}: stacked depth {value.shape[0]} '
                                 f'!= depth {depth}')
            rest = path[len('blocks/block/'):]
            for i in range(depth):
                out[f'blocks/{i}/{rest}'] = value[i]
        else:
            m = re.match(r'blocks_(\d+)/(.*)', path)
            out[f'blocks/{m[1]}/{m[2]}' if m else path] = value
    return out


def _check_qkv(sd: Mapping[str, torch.Tensor], key: str, num_heads: int,
               rope_layout: str) -> None:
    """The qkv projection splits into the heads; split RoPE needs an even
    per-axis dim. The q/k basis carries over unpermuted, so the port's
    model must use the JAX model's RoPE layout."""
    qkv = sd.get(key)
    if qkv is None:
        return
    c = qkv.shape[1]
    if qkv.shape[0] != 3 * c or c % num_heads:
        raise ValueError(f'qkv {tuple(qkv.shape)} does not split into '
                         f'{num_heads} heads')
    if rope_layout == 'split' and (c // num_heads // 2) % 2:
        raise ValueError('split RoPE needs an even per-axis rope dim')


def state_dict_from_jax(params_np: Mapping[str, Any], *, depth: int,
                        num_heads: int, adaln_type: str,
                        rope_layout: str = 'split') -> Dict[str, torch.Tensor]:
    """JAX FiT params -> this package's FiT state_dict (float32 tensors).

    ``rope_layout`` is the layout of the JAX model the params come from; the
    port's FiT must be built with the same layout, because the q/k basis of
    the qkv projection carries over unpermuted. ``num_heads`` and
    ``adaln_type`` are checked against the tree.
    """
    flat = _unstack_blocks(_flatten(params_np.get('params', params_np)),
                           depth)
    sd = dict(_leaf(path, value) for path, value in flat.items())
    _check_qkv(sd, 'blocks.0.attn.qkv.weight', num_heads, rope_layout)
    lora = 'blocks.0.adaLN_modulation.fc1.weight' in sd
    if depth and lora != (adaln_type == 'lora'):
        raise ValueError(f'adaln_type={adaln_type!r} does not match the '
                         'adaLN parameters in the tree')
    return sd


_LWD_LISTS = ('x_embedders|t_embedders|y_embedders|final_layers|'
              'rep_segments|segments')
_LWD_LIST = re.compile(rf'({_LWD_LISTS})_(\d+)/(.*)')
_STACK = '/stack/block/'


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One leaf of the JAX model's parameter tree, as the port holds it.

    path: its '/'-joined flax path; names: the port's parameters it holds
    (one, or one a block in block order when ``stacked``: JAX stacks them
    along a new leading axis); transpose: a Dense kernel, the transpose of
    each port ``nn.Linear`` weight; ndim: the JAX leaf's rank."""
    path: str
    names: Tuple[str, ...]
    stacked: bool
    transpose: bool
    ndim: int

    def to_jax(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The leaf in JAX's layout from its port tensors (``names``'
        order)."""
        ts = [t.t() if self.transpose else t for t in tensors]
        return torch.stack(ts) if self.stacked else ts[0]

    def from_jax(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The inverse of ``to_jax``: one port tensor a name (views)."""
        parts = t.unbind(0) if self.stacked else [t]
        return [p.t() if self.transpose else p for p in parts]

    def part(self, shapes: Mapping[str, Sequence[int]], layout=None
             ) -> 'LeafPart':
        """The part of this leaf, in JAX's layout, that this rank holds
        (``shapes``: the port parameters' one-process shapes by name).
        Without ``layout`` the whole leaf; under one (a
        ``parallel.sharding.ShardedLayout``): FSDP2's chunk of the port
        tensor's dim 0 (JAX's last axis of a Dense kernel), the tensor
        split's rows or columns (``layout.tp``, inside which FSDP2
        chunks), and a stage's blocks of a stack."""
        first = self.names[0]
        shape = list(shapes[first])
        index: List[Optional[torch.Tensor]] = [None] * len(shape)
        axes: List[Tuple[str, ...]] = [()] * len(shape)
        if layout is None:
            if self.transpose:
                shape = shape[::-1]
            if self.stacked:
                shape, index, axes = [len(self.names)] + shape, \
                    [None] + index, [()] + axes
            return LeafPart(self.names, tuple(shape), tuple(index),
                            tuple(axes), ())
        split = layout.tp.get(first)
        if split is not None:
            index[split.dim] = split.index[layout.mesh.coordinate('tensor')]
            axes[split.dim] = ('tensor',)
        if layout.fsdp:
            rows = torch.arange(shape[0]) if index[0] is None else index[0]
            chunks = rows.chunk(layout.mesh.size('fsdp'))
            f = layout.mesh.coordinate('fsdp')
            index[0] = chunks[f] if f < len(chunks) else rows[:0]
            axes[0] += ('fsdp',)
        if self.transpose:
            shape, index, axes = shape[::-1], index[::-1], axes[::-1]
        held = tuple(n for n in self.names if layout.holds(n))
        if self.stacked:
            staged = any(layout.stage_owner.get(n) is not None
                         for n in self.names)
            shape = [len(self.names)] + shape
            index = [torch.tensor([i for i, n in enumerate(self.names)
                                   if n in held], dtype=torch.long)
                     if staged else None] + index
            axes = [('stage',) if staged else ()] + axes
        split_by = {a for n in self.names for a in layout.axes(n)}
        return LeafPart(held, tuple(shape), tuple(index), tuple(axes),
                        tuple(a for a in ('fsdp', 'tensor', 'stage')
                              if a in split_by))


@dataclasses.dataclass(frozen=True)
class LeafPart:
    """What one rank holds of a ``JaxLeaf``, in JAX's layout.

    names: the leaf's parameters it holds (a pipeline stage: its blocks;
    none where another stage owns an unstacked block's leaf); shape: the
    whole leaf's; index[a]: the positions along axis ``a`` of its part
    (None: the whole axis); axes[a]: the mesh axes that split axis ``a``;
    split: every mesh axis over which the ranks' parts tile the leaf.
    Data and sequence split no leaf: their ranks hold the same parts."""
    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    index: Tuple[Optional[torch.Tensor], ...]
    axes: Tuple[Tuple[str, ...], ...]
    split: Tuple[str, ...]

    def place(self, t: torch.Tensor, axes: Sequence[int],
              local: Optional[torch.Tensor]) -> torch.Tensor:
        """A zero tensor over the leaf's axes ``axes`` whose entries at
        this part's positions are ``local`` (None: all zero)."""
        shape = [self.shape[a] for a in axes]
        if local is None:
            return t.new_zeros(shape)
        for i, a in enumerate(axes):
            idx = self.index[a]
            if idx is not None:
                whole = local.new_zeros(local.shape[:i] + (shape[i],)
                                        + local.shape[i + 1:])
                local = whole.index_copy_(i, idx.to(local.device), local)
        return local

    def take(self, whole: torch.Tensor, axes: Sequence[int]
             ) -> torch.Tensor:
        """This part's entries of ``whole``, a tensor over the leaf's
        axes ``axes``."""
        for i, a in enumerate(axes):
            idx = self.index[a]
            if idx is not None:
                whole = whole.index_select(i, idx.to(whole.device))
        return whole


def jax_leaves(model: torch.nn.Module) -> List[JaxLeaf]:
    """The leaves of the JAX counterpart of ``model`` (a FiT, whose blocks
    JAX stacks when ``scan_blocks``; or an LwD model, whose every
    ``BlockStack`` it stacks), in the order of ``model.named_parameters``'
    first members."""
    from fitv2_tpu_torch.models.fit import FiT
    from fitv2_tpu_torch.models.fit_lwd import BlockStack

    def jax_prefix(name: str) -> str:
        name = re.sub(rf'(^|\.)({_LWD_LISTS})\.(\d+)', r'\1\2_\3', name)
        if isinstance(model, FiT):
            name = re.sub(r'^blocks\.(\d+)', r'blocks_\1', name)
        return name.replace('.', '/')

    stacks = {name: jax_prefix(name) + '/stack/block'
              for name, m in model.named_modules()
              if isinstance(m, BlockStack)}
    if isinstance(model, FiT) and model.scan_blocks:
        stacks['blocks'] = 'blocks/block'
    from fitv2_tpu_torch.parallel.sharding import (
        ColumnParallelLinear, RowParallelLinear)
    linear = {id(m.weight) for m in model.modules()
              if isinstance(m, (torch.nn.Linear, ColumnParallelLinear,
                                RowParallelLinear))}
    leaves: Dict[str, list] = {}
    for name, p in model.named_parameters():
        stack = next((s for s in stacks if name.startswith(s + '.')), None)
        if stack is not None:
            rest = name[len(stack) + 1:].split('.', 1)[1]
            path = f'{stacks[stack]}/{rest.replace(".", "/")}'
        else:
            path = jax_prefix(name)
        if id(p) in linear:
            path = path[:-len('weight')] + 'kernel'
        entry = leaves.setdefault(path, [[], stack is not None,
                                         id(p) in linear, p.dim()])
        entry[0].append(name)
    return [JaxLeaf(path, tuple(names), stacked, transpose, ndim + stacked)
            for path, (names, stacked, transpose, ndim) in leaves.items()]


def _lwd_paths(flat: Mapping[str, np.ndarray]):
    """(the port's '/'-joined path, value) of each leaf of a flattened JAX
    LwD tree: ``{list}_{i}/...`` -> ``{list}/{i}/...``, and each block
    stack's ``.../stack/block/...`` leaf unstacked along its own length
    into ``.../{j}/...``."""
    for path, value in flat.items():
        m = _LWD_LIST.fullmatch(path)
        if m:
            path = f'{m[1]}/{m[2]}/{m[3]}'
        if _STACK in path:
            head, rest = path.split(_STACK, 1)
            for i in range(value.shape[0]):
                yield f'{head}/{i}/{rest}', value[i]
        else:
            yield path, value


def lwd_state_from_jax(params_np: Mapping[str, Any], model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """JAX FiTLwD / FiTLwDSharedEncSepDec params (numpy leaves) -> the
    port's ``model.state_dict()`` (float32 tensors). The names and shapes
    are held against ``model``'s (a block stack of another length, a
    missing head or a leaf of another shape raises); ``model`` must use the
    JAX model's RoPE layout."""
    sd = dict(_leaf(path, value) for path, value in
              _lwd_paths(_flatten(params_np.get('params', params_np))))
    _check_qkv(sd, 'segments.0.0.attn.qkv.weight', model.num_heads,
               model.rope_layout)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise ValueError(f'the JAX tree does not match the model: missing '
                         f'{missing[:5]}, unexpected {unexpected[:5]}')
    for name, t in sd.items():
        if t.shape != want[name].shape:
            raise ValueError(f'{name}: shape {tuple(t.shape)} != '
                             f'{tuple(want[name].shape)}')
    return sd


def quant_state_from_jax(collections_np: Mapping[str, Any], depth: int
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``{'quant_calib', 'quant_weights'}`` trees (numpy leaves,
    scan-stacked under ``blocks/block/`` or per block) -> the port's
    ``Int8Linear`` buffers by qualified name: ``act_absmax`` () f32,
    ``kernel_q`` (K, N) -> ``weight_q`` (N, K) int8, ``w_scale`` (1, N) ->
    (N,) f32."""
    flat = _quant_collections(collections_np)
    return dict(_quant_leaf(path, value)
                for path, value in _unstack_blocks(flat, depth).items())


def _quant_collections(collections_np: Mapping[str, Any]
                       ) -> Dict[str, np.ndarray]:
    flat = {}
    for coll in ('quant_calib', 'quant_weights'):
        if coll in collections_np:
            flat.update(_flatten(collections_np[coll]))
    return flat


def _quant_leaf(path: str, value: np.ndarray) -> Tuple[str, torch.Tensor]:
    """One quantization leaf at the port's '/'-joined layer path -> its
    ``Int8Linear`` buffer name and tensor."""
    *layer, leaf = path.split('/')
    name = '.'.join(layer)
    if leaf == 'kernel_q':
        return f'{name}.weight_q', torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(value, -1, -2)).astype(np.int8))
    if leaf in ('w_scale', 'act_absmax'):
        arr = np.array(value, np.float32)  # a writable copy
        return f'{name}.{leaf}', torch.from_numpy(
            arr.reshape(-1) if leaf == 'w_scale' else arr.reshape(()))
    raise ValueError(f'{path}: not a quantization leaf')


def lwd_quant_state_from_jax(collections_np: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """``quant_state_from_jax`` for the LwD family: JAX's ``quant_calib`` /
    ``quant_weights`` trees over the segment, shared-trunk,
    representation and mid-block stacks (each ``.../stack/block/...``,
    stacked along its own length) -> the port's ``Int8Linear`` buffers,
    through ``lwd_state_from_jax``'s path map."""
    return dict(_quant_leaf(path, value) for path, value in
                _lwd_paths(_quant_collections(collections_np)))


def _conv_leaf(path: str, value: np.ndarray) -> Tuple[str, torch.Tensor]:
    """A flax conv / BatchNorm leaf -> the port's name and tensor: a
    kernel (k..., I, O) -> ``weight`` (O, I, k...); BatchNorm ``scale``
    -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``."""
    *layer, leaf = path.split('/')
    if leaf == 'kernel':
        leaf = 'weight'
        value = np.moveaxis(value, (-1, -2), (0, 1))
    else:
        leaf = {'scale': 'weight', 'mean': 'running_mean',
                'var': 'running_var'}.get(leaf, leaf)
    return '.'.join([*layer, leaf]), torch.from_numpy(
        np.array(value, dtype=np.float32, order='C'))


def disc_state_from_jax(params_np: Mapping[str, Any],
                        batch_stats_np: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``NLayerDiscriminator`` / ``NLayerDiscriminator3D`` params and
    ``batch_stats`` (numpy leaves) -> the port's discriminator
    ``state_dict``."""
    out = dict(_conv_leaf(p, v) for p, v in
               _flatten(params_np.get('params', params_np)).items())
    out.update(_conv_leaf(p, v) for p, v in _flatten(
        batch_stats_np.get('batch_stats', batch_stats_np)).items())
    return out


def lpips_state_from_jax(params_np: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS`` params (numpy leaves: ``vgg/conv{i}``, ``lin{i}``) ->
    the port's ``LPIPS.state_dict()``."""
    return dict(_conv_leaf(p, v) for p, v in
                _flatten(params_np.get('params', params_np)).items())


def inception_state_from_jax(params_np: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX InceptionV3 params (numpy leaves) -> the port's InceptionV3
    state_dict: ``conv/kernel`` (kh, kw, I, O) -> ``conv.weight``
    (O, I, kh, kw), ``fc/kernel`` (in, out) -> ``fc.weight`` (out, in)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params_np.get('params', params_np)).items():
        *layer, leaf = path.split('/')
        if leaf == 'kernel':
            leaf = 'weight'
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 \
                else value.T
        out['.'.join([*layer, leaf])] = torch.from_numpy(
            np.array(value, dtype=np.float32, order='C'))
    return out


_TEACHER_RENAMES = (
    (r'^patch_embed/', 'patch_embed/proj/'),
    (r'^block(\d+)/(qkv|proj)/', r'blocks/\1/attn/\2/'),
    (r'^block(\d+)/(fc1|fc2|w12|w3)/', r'blocks/\1/mlp/\2/'),
    (r'^block(\d+)/(ls[12])_gamma$', r'blocks/\1/\2/gamma'),
    (r'^block(\d+)/', r'blocks/\1/'),
    (r'^resblock(\d+)/attn/in_proj/kernel$',
     r'transformer/resblocks/\1/attn/in_proj_weight'),
    (r'^resblock(\d+)/attn/in_proj/bias$',
     r'transformer/resblocks/\1/attn/in_proj_bias'),
    (r'^resblock(\d+)/(c_fc|c_proj)/', r'transformer/resblocks/\1/mlp/\2/'),
    (r'^resblock(\d+)/', r'transformer/resblocks/\1/'),
    (r'/scale$', '/weight'),
)


def teacher_state_from_jax(params_np: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX VisionTransformer / DinoV2ViT / CLIPVisionTransformer params
    (numpy leaves) -> the state dict of the port's module of the same
    family: conv kernels (kh, kw, I, O) -> (O, I, kh, kw), Dense kernels
    and CLIP's packed ``in_proj`` (I, O) -> (O, I), LayerNorm ``scale`` ->
    ``weight``, the torch hub / OpenAI names."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params_np.get('params', params_np)).items():
        for pat, rep in _TEACHER_RENAMES:
            path = re.sub(pat, rep, path)
        if path.endswith('kernel') or path.endswith('in_proj_weight'):
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 \
                else value.T
            path = re.sub(r'kernel$', 'weight', path)
        out[path.replace('/', '.')] = torch.from_numpy(
            np.array(value, dtype=np.float32, order='C'))
    return out


def _find_state(node: Any, *fields: str) -> Any:
    """The first optax state (a namedtuple) in ``node`` with ``fields``."""
    if all(hasattr(node, f) for f in fields):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_state(child, *fields)
            if found is not None:
                return found
    return None


def _came_tree(node: Any) -> Any:
    """The params-shaped tree of CAME leaf states in an optax state."""
    def is_came(x):
        return hasattr(x, 'r_row') and hasattr(x, 'm')

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, Mapping) else [v]
    if isinstance(node, Mapping):  # a multi_transform group masks the rest
        return node if any(map(is_came, leaves(node))) else None
    if isinstance(node, (tuple, list)) and not is_came(node):
        for child in node:
            found = _came_tree(child)
            if found is not None:
                return found
    return None


def came_state_from_jax(opt_state_np: Any, model: torch.nn.Module,
                        optimizer) -> None:
    """Copy the CAME state of a JAX ``opt_state`` (numpy leaves) into the
    port's ``CAME`` (over ``jax_leaves(model)``): each of its leaves' m and
    factored r/s (or r_full), in JAX's layout, as the port keeps them; the
    count of a schedule, where JAX keeps one."""
    tree = _came_tree(opt_state_np)
    if tree is None:
        raise ValueError('no CAME state in opt_state')
    flat: Dict[str, Any] = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f'{prefix}/{k}' if prefix else k
            if isinstance(v, Mapping):
                walk(v, path)
            else:
                flat[path] = v
    walk(tree, '')
    for leaf in optimizer.leaves:
        st = flat[leaf.path]
        keys = (('m', 'r_row', 'r_col', 's_row', 's_col') if leaf.ndim >= 2
                else ('m', 'r_full'))
        first = optimizer.leaf_params(leaf)[0]
        optimizer.state[first] = {
            k: torch.from_numpy(np.array(getattr(st, k), np.float32)).to(
                first.device) for k in keys}
    def schedule_state(node):  # optax's ScaleByScheduleState(count)
        if 'count' in getattr(node, '_fields', ()):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = schedule_state(child)
                if found is not None:
                    return found
        return None
    sched = schedule_state(opt_state_np)
    if sched is not None:
        optimizer.param_groups[0]['count'] = int(sched.count)


def train_state_from_jax(state_np: Any, model: torch.nn.Module, cfg,
                         *, rope_layout: str = 'split'):
    """A JAX ``TrainState`` (``jax.device_get`` of one: numpy leaves) ->
    a ``fitv2_tpu_torch.train.TrainState`` for the port's fp32 ``model``
    (whose parameters become the master parameters) and
    ``OptimizerConfig`` ``cfg``.

    params, ema_params, adam's mu (cast to ``cfg.mu_dtype``; fp32 when it
    is None, as in the LwD trainer, whose JAX state keeps an fp32 mu) and
    nu go through ``state_dict_from_jax`` (``lwd_state_from_jax`` for an
    LwD model); the adam count becomes the optimizer's
    count, ``state.step`` the step; under ``optax.MultiSteps`` its
    mini-step, gradient step and accumulated gradients carry over too.
    A CAME state (``cfg.optimizer == 'came'``) goes through
    ``came_state_from_jax``."""
    from fitv2_tpu_torch.models.fit_lwd import FiTLwD
    from fitv2_tpu_torch.train.train_step import create_train_state
    if isinstance(model, FiTLwD):
        def convert(tree):
            return lwd_state_from_jax(tree, model)
    else:
        def convert(tree):
            return state_dict_from_jax(
                tree, depth=model.depth, num_heads=model.num_heads,
                adaln_type=model.adaln_type, rope_layout=rope_layout)
    state = create_train_state(model, cfg)
    came = cfg.optimizer == 'came'
    adam = None if came else _find_state(state_np.opt_state, 'mu', 'nu',
                                         'count')
    if adam is None and not came:
        raise ValueError('no adam state (mu, nu, count) in opt_state')
    multi = _find_state(state_np.opt_state, 'mini_step', 'acc_grads')
    with torch.no_grad():
        for key, tree in (('params', state_np.params),
                          ('ema_params', state_np.ema_params)):
            sd = convert(tree)
            for name, t in getattr(state, key).items():
                t.copy_(sd[name])
        if came:
            came_state_from_jax(state_np.opt_state, model, state.optimizer)
        else:
            mu, nu = convert(adam.mu), convert(adam.nu)
            for name, p in state.params.items():
                state.optimizer.state[p] = {
                    'mu': mu[name].to(p.device, cfg.mu_dtype or p.dtype),
                    'nu': nu[name].to(p.device, p.dtype)}
        if multi is not None:
            if state.accumulator is None:
                raise ValueError('the JAX state accumulates gradients; set '
                                 'grad_accum_steps')
            acc = convert(multi.acc_grads)
            torch._foreach_copy_(state.accumulator.acc,
                                 [acc[n] for n in state.params])
            state.accumulator.mini_step = int(multi.mini_step)
            state.accumulator.gradient_step = int(multi.gradient_step)
    if not came:
        for group in state.optimizer.param_groups:
            group['count'] = int(adam.count)
    state.step = int(state_np.step)
    return state
