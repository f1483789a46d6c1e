"""The train step: loss, gradients, clipping, AdamW or CAME, EMA.

Counterpart of fitv2_tpu/train/train_step.py, whose optimizer is optax's
``chain(clip_by_global_norm, adamw | came)``, wrapped in ``MultiSteps`` when
gradients accumulate, or a ``multi_transform`` of such chains over groups
of parameters (``make_grouped_optimizer``, ``make_finetune_optimizer``).
The port's pieces follow optax's arithmetic:

- ``clip_by_global_norm``: the gradients are scaled by ``max / norm`` only
  when the global norm is not below ``max`` (no epsilon added);
- ``AdamW``: the moments are updated in fp32; the bias-corrected first
  moment is formed from that fp32 value before the stored moment is cast
  to ``mu_dtype`` (bf16 in the trainer); the schedule takes the count of
  updates applied so far, so the first update uses ``lr(0)``;
- ``GradAccumulator`` (``optax.MultiSteps``): the running mean of k
  micro-gradients, clipped and applied on the k-th; the optimizer's count
  advances only then;
- ``update_ema`` runs after every micro-step, as in JAX;
- ``MultiTransform`` (``optax.multi_transform``): each group's chain sees
  only its own parameters, so its clip takes the global norm of the
  group's gradients (over every shard under model sharding); a frozen
  group (``set_to_zero``) keeps its bits and holds no state. CAME is
  train/came.py.

``make_step`` takes the loss as a function: the flow loss here
(``make_train_step``), the improved-diffusion loss in
train/ddpm_train_step.py.

Mixed precision: the trainer keeps fp32 master parameters (``TrainState``)
and runs a compute-dtype copy of the model, whose gradients are copied
into the masters, which is what flax's cast-at-use gives JAX. With an fp32
model the masters are the model's own parameters.

Data parallel (more than one process, ``parallel.init_distributed``): each
process computes the loss on its rows of the global batch, drawing t, the
noise and the label drops at the global batch from the (seed, step)
generator and keeping its rows (``parallel.row_shard_draws``); the fp32
gradients are averaged across the processes in one flat all-reduce before
the norm and the clip, and the scalar metrics are averaged too. Every loss
here is a mean over the batch of per-sample means, so with equal shards
the average of the processes' gradients is the whole batch's: a run's
result depends on the process count only through the order of that sum.

Model sharding (``make_step(..., layout=...)``, parallel/sharding.py):
the model's parameters are this rank's shards (FSDP2's local tensors,
tensor-parallel slices, a pipeline stage's blocks); the draws keep the
rows of the rank's data x fsdp batch shard; the layout reduces the local
gradients over the groups that share them and takes the global norm over
every shard; AdamW, CAME (train/came.py: its statistics summed over
the axes that split each JAX leaf) and the EMA run on the local shards.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple, Union)

import torch
from torch import nn

from fitv2_tpu_torch.flow.transport import Transport
from fitv2_tpu_torch.parallel.mesh import (
    all_reduce_mean_, process_count, row_shard_draws)
from fitv2_tpu_torch.parallel.sharding import local
from fitv2_tpu_torch.train.came import CAME

Tensor = torch.Tensor
Schedule = Callable[[int], float]
# (model, batch, generator, draws) -> (mean loss, extra metrics)
LossFn = Callable[..., Tuple[Tensor, Dict[str, Tensor]]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The JAX package's AdamW defaults. ``mu_dtype`` None keeps the first
    moment in the parameters' dtype (fp32). ``optimizer='came'`` takes b1
    and b2 from ``betas``, with CAME's b3 0.9999 and eps (1e-30, 1e-16),
    as JAX's ``make_optimizer``; ``eps`` and ``mu_dtype`` are Adam's."""
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    lr_schedule: Optional[Schedule] = None  # step -> lr; overrides the rate
    optimizer: str = 'adamw'
    mu_dtype: Optional[torch.dtype] = None


def global_norm(tensors: List[Tensor]) -> Tensor:
    """fp32 0-d L2 norm over all tensors, on their device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: List[Tensor], max_norm: float,
                        norm: Optional[Tensor] = None) -> Tensor:
    """optax.clip_by_global_norm in place: scale every gradient by
    ``max_norm / norm`` unless ``norm < max_norm``. Returns the norm (0-d,
    on the device: no host sync)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


# fp32 bytes of the parameters that an update (AdamW, the EMA) takes at
# once: its temporaries (three fp32 copies in AdamW) stay this size, not
# the model's (at FiTv2-HR-3B, 2.97 B parameters, they would be 35.7 GB)
UPDATE_CHUNK_BYTES = 256 << 20


def update_chunks(tensors: Sequence[Tensor]) -> Iterator[slice]:
    """Consecutive slices of ``tensors`` of at most UPDATE_CHUNK_BYTES in
    fp32 each (a larger tensor alone). Every update is elementwise, so
    updating the slices one after another gives the same bits."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        n = t.numel() * 4
        if size and size + n > UPDATE_CHUNK_BYTES:
            yield slice(start, i)
            start, size = i, 0
        size += n
    if start < len(tensors):
        yield slice(start, len(tensors))


class AdamW(torch.optim.Optimizer):
    """optax.adamw (eps_root 0, no Nesterov): ``mu_hat / (sqrt(nu_hat) +
    eps) + weight_decay * p``, scaled by ``-lr(count)``.

    ``lr`` is a rate or a ``step -> lr`` schedule called with the count of
    updates applied so far. ``mu_dtype`` is the stored first moment's dtype
    (None: the parameter's); the moment is updated in fp32 and cast after
    the bias-corrected value is formed, as optax does. The count is kept in
    each parameter group, so it is in ``state_dict()``."""

    def __init__(self, params, lr: Union[float, Schedule] = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, count=0))
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.mu_dtype = mu_dtype

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """torch's loader casts floating state to the parameter's dtype;
        the first moment goes back to ``mu_dtype`` (exactly: it was
        saved in that dtype)."""
        super().load_state_dict(state_dict)
        if self.mu_dtype is not None:
            for state in self.state.values():
                if 'mu' in state:
                    state['mu'] = state['mu'].to(self.mu_dtype)

    def _moments(self, p: Tensor) -> Tuple[Tensor, Tensor]:
        state = self.state[p]
        if not state:
            state['mu'] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
            state['nu'] = torch.zeros_like(p)
        return state['mu'], state['nu']

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('AdamW.step takes no closure')
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                if not group['params']:  # a rank that holds none of a
                    group['count'] += 1  # sharded group's: count along
                continue
            lr = self.schedule(group['count'])
            group['count'] += 1
            count = group['count']
            b1, b2 = group['betas']
            # optax's bias corrections: 1 - decay**count in float32
            bc1 = float(torch.tensor(1.0) - torch.tensor(b1) ** count)
            bc2 = float(torch.tensor(1.0) - torch.tensor(b2) ** count)
            for part in update_chunks(params):
                self._update(group, params[part], lr, bc1, bc2)

    def _update(self, group, params: List[Tensor], lr: float, bc1: float,
                bc2: float) -> None:
        b1, b2 = group['betas']
        grads = [p.grad for p in params]
        mus, nus = zip(*(self._moments(p) for p in params))
        # mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, in fp32;
        # as in optax, b1 mu is a product in the stored dtype (b1 rounded
        # to it), rounded before the fp32 sum
        b1_mu = float(torch.tensor(b1, dtype=mus[0].dtype))
        mus32 = [m.float() for m in torch._foreach_mul(mus, b1_mu)]
        torch._foreach_add_(mus32, torch._foreach_mul(grads, 1.0 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, sq)
        del sq
        update = torch._foreach_div(mus32, bc1)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group['eps'])
        torch._foreach_div_(update, denom)
        del denom
        if group['weight_decay']:
            torch._foreach_add_(update, torch._foreach_mul(
                params, group['weight_decay']))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(params, update)
        torch._foreach_copy_(list(mus), mus32)


class GradAccumulator:
    """optax.MultiSteps with ``use_grad_mean``: ``acc + (g - acc) / (n +
    1)`` over ``every_k`` micro-steps; ``update`` returns the mean on the
    k-th and None before it."""

    def __init__(self, every_k: int, like: List[Tensor]):
        self.every_k = every_k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(t, dtype=torch.float32) for t in like]

    def update(self, grads: List[Tensor]) -> Optional[List[Tensor]]:
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        emit = self.mini_step == self.every_k - 1
        self.mini_step = (self.mini_step + 1) % self.every_k
        if not emit:
            return None
        out, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
        self.gradient_step += 1
        return out

    def state_dict(self) -> Dict[str, Any]:
        return dict(mini_step=self.mini_step,
                    gradient_step=self.gradient_step, acc=self.acc)

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.mini_step = int(sd['mini_step'])
        self.gradient_step = int(sd['gradient_step'])
        with torch.no_grad():
            torch._foreach_copy_(self.acc, list(sd['acc']))


def update_ema(ema_params: Dict[str, Tensor], params: Dict[str, Tensor],
               decay: float = 0.9999) -> Dict[str, Tensor]:
    """In place, ``ema <- ema * decay + p * (1 - decay)``.

    The EMA must be float32: in bf16 the increment falls below the dtype's
    precision and the EMA never moves off its initial value; a dtype whose
    eps exceeds ``1 - decay`` warns, as in JAX."""
    names = list(ema_params)
    emas = [ema_params[n] for n in names]
    for e in emas:
        eps = torch.finfo(e.dtype).eps
        if eps > 1.0 - decay:
            warnings.warn(
                f'update_ema: EMA dtype {e.dtype} has machine eps {eps:.1e} '
                f'> 1-decay {1.0 - decay:.1e}; the EMA update underflows and '
                'ema_params stays frozen at its initial value. Keep EMA (and '
                'params) in float32.', stacklevel=2)
            break
    with torch.no_grad():
        for part in update_chunks(emas):
            ps = torch._foreach_mul([params[n].to(e.dtype) for n, e in zip(
                names[part], emas[part])], 1.0 - decay)
            torch._foreach_mul_(emas[part], decay)
            torch._foreach_add_(emas[part], ps)
    return ema_params


def scale_lr_by_global_batch(base_lr: float, global_batch_size: int,
                             base_batch_size: int = 256) -> float:
    """Linear LR scaling."""
    return base_lr * global_batch_size / base_batch_size


class MultiTransform:
    """``optax.multi_transform`` over named parameters: ``labels`` (name ->
    label) sends each parameter to ``optimizers[label]``, which clips its
    group's gradients by ``max_grad_norms[label]`` (the group's own global
    norm, kept in ``norms``) and steps; a label whose optimizer is None is
    frozen (``optax.set_to_zero``: the parameters keep their bits).
    ``params``: the parameters by name; ``members``: each label's names in
    order. Under model sharding (``layout``) ``params`` are this rank's
    local tensors and ``members`` every parameter of the mesh; each group's
    norm is then taken over every shard (``layout.global_norm``), by every
    rank in the same order, whichever of the group's parameters it
    holds."""

    def __init__(self, labels: Dict[str, str],
                 optimizers: Dict[str, Optional[torch.optim.Optimizer]],
                 max_grad_norms: Dict[str, float],
                 params: Dict[str, Tensor], members: Dict[str, List[str]],
                 layout=None):
        self.labels = labels
        self.optimizers = optimizers
        self.max_grad_norms = max_grad_norms
        self.params = params
        self.members = members
        self.layout = layout
        self.norms: Dict[str, Tensor] = {}

    def step(self) -> None:
        for label, opt in self.optimizers.items():
            if opt is None:
                continue
            names = [n for n in self.members[label] if n in self.params
                     and self.params[n].grad is not None]
            grads = [self.params[n].grad for n in names]
            if self.layout is not None:
                norm = self.layout.global_norm(names, grads)
            elif grads:
                norm = global_norm(grads)
            else:
                continue
            self.norms[label] = clip_by_global_norm(
                grads, self.max_grad_norms[label], norm)
            opt.step()

    def state_dict(self) -> Dict[str, Any]:
        return {label: opt.state_dict()
                for label, opt in self.optimizers.items() if opt is not None}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for label, opt in self.optimizers.items():
            if opt is not None:
                opt.load_state_dict(state_dict[label])


Optimizer = Union[AdamW, CAME, MultiTransform]


def build_optimizer(params: Dict[str, Tensor], cfg: OptimizerConfig,
                    model: nn.Module, layout=None,
                    names: Optional[Sequence[str]] = None
                    ) -> Union[AdamW, CAME]:
    """``cfg``'s optimizer over ``params`` (name -> master of ``model``'s
    parameter of that name), without the clip (``make_step`` clips). CAME
    runs over the leaves of ``model``'s JAX counterpart
    (``ckpt.jax_leaves``); under model sharding (``layout``) over this
    rank's parts of them, ``names`` being every parameter it updates over
    the mesh (default: all)."""
    lr = cfg.lr_schedule or cfg.learning_rate
    if cfg.optimizer == 'adamw':
        return AdamW([{'params': list(params.values())}], lr=lr,
                     betas=cfg.betas, eps=cfg.eps,
                     weight_decay=cfg.weight_decay, mu_dtype=cfg.mu_dtype)
    if cfg.optimizer == 'came':
        from fitv2_tpu_torch.ckpt.convert import jax_leaves
        return CAME(params, jax_leaves(model), lr=lr,
                    betas=(cfg.betas[0], cfg.betas[1], 0.9999),
                    weight_decay=cfg.weight_decay, layout=layout,
                    names=names)
    raise ValueError(f'unknown optimizer {cfg.optimizer!r} '
                     "(expected 'adamw' or 'came')")


def make_grouped_optimizer(params: Dict[str, Tensor],
                           group_fn: Callable[[str, Tensor], str],
                           group_configs: Dict[str, Optional[OptimizerConfig]],
                           model: nn.Module, layout=None) -> MultiTransform:
    """Per-group optimizers: ``group_fn(name, param) -> label`` sends each
    parameter to ``group_configs[label]``, an ``OptimizerConfig`` (JAX's
    ``make_optimizer``: its clip, then AdamW or CAME) or None (frozen).
    ``model``: as ``build_optimizer``'s. Under model sharding (``layout``)
    every parameter of the mesh is labelled, each given to ``group_fn`` as
    a meta tensor of its one-process shape, so that every rank makes the
    same groups."""
    if layout is None:
        every = params
    else:
        every = {n: torch.empty(layout.shapes[n], device='meta')
                 for n in layout.names}
    labels = {}
    for name, p in every.items():
        label = group_fn(name, p)
        if label not in group_configs:
            raise KeyError(f'{name}: label {label!r} not in '
                           f'{sorted(group_configs)}')
        labels[name] = label
    optimizers, members = {}, {}
    for label, cfg in group_configs.items():
        members[label] = [n for n in every if labels[n] == label]
        mine = {n: params[n] for n in members[label] if n in params}
        optimizers[label] = (
            None if cfg is None or not members[label] else build_optimizer(
                mine, cfg, model, layout, members[label]))
    return MultiTransform(labels, optimizers, {
        label: cfg.max_grad_norm for label, cfg in group_configs.items()
        if cfg is not None}, params, members, layout)


def make_finetune_optimizer(params: Dict[str, Tensor], cfg: OptimizerConfig,
                            unfreeze: Sequence[str],
                            finetune_type: str = 'partial', *,
                            model: nn.Module, layout=None
                            ) -> Union[AdamW, CAME, MultiTransform]:
    """Freeze by name: with ``finetune_type='full'`` every parameter trains
    (``cfg``'s optimizer); otherwise only those whose name contains a
    substring of ``unfreeze`` ('adaLN', 'norm' ...) train, under ``cfg``'s
    clip and optimizer, and the rest are frozen. ``model`` and ``layout``:
    as ``build_optimizer``'s."""
    if finetune_type == 'full':
        return build_optimizer(params, cfg, model, layout)
    unfreeze = tuple(unfreeze)
    return make_grouped_optimizer(
        params, lambda name, _: ('train' if any(u in name for u in unfreeze)
                                 else 'frozen'),
        {'train': cfg, 'frozen': None}, model, layout)


@dataclasses.dataclass
class TrainState:
    """What a train step carries from one call to the next.

    step: micro-steps taken; params: fp32 master parameters by the
    model's names (the model's own parameters when it computes in fp32);
    ema_params: their fp32 EMA; optimizer: AdamW, CAME or a
    ``MultiTransform`` of them, with its state and the count of applied
    updates; accumulator: the running gradient mean when gradients
    accumulate."""
    step: int
    params: Dict[str, Tensor]
    ema_params: Dict[str, Tensor]
    optimizer: Optimizer
    accumulator: Optional[GradAccumulator] = None

    def state_dict(self) -> Dict[str, Any]:
        return dict(step=self.step, params=self.params,
                    ema_params=self.ema_params,
                    optimizer=self.optimizer.state_dict(),
                    accumulator=(self.accumulator.state_dict()
                                 if self.accumulator else None))

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a ``state_dict()`` into this state's tensors in place; the
        names, shapes and dtypes must match."""
        for key in ('params', 'ema_params'):
            mine, theirs = getattr(self, key), sd[key]
            if set(mine) != set(theirs):
                raise KeyError(f'{key}: names differ: '
                               f'{sorted(set(mine) ^ set(theirs))[:5]}')
            with torch.no_grad():
                for name, t in mine.items():
                    if theirs[name].shape != t.shape:
                        raise ValueError(f'{key}.{name}: shape '
                                         f'{tuple(theirs[name].shape)} != '
                                         f'{tuple(t.shape)}')
                    t.copy_(theirs[name])
        self.optimizer.load_state_dict(sd['optimizer'])
        if (sd['accumulator'] is None) != (self.accumulator is None):
            raise ValueError('gradient accumulation differs from the '
                             'checkpoint')
        if self.accumulator is not None:
            self.accumulator.load_state_dict(sd['accumulator'])
        self.step = int(sd['step'])


def create_train_state(model: nn.Module, cfg: OptimizerConfig,
                       optimizer_fn: Optional[Callable[
                           [Dict[str, Tensor]], Optimizer]] = None,
                       layout=None) -> TrainState:
    """Masters, EMA, optimizer and accumulator for ``model``. An fp32
    model's parameters are the masters; any other dtype gets fp32 copies on
    the model's device. The optimizer is ``cfg``'s (``build_optimizer``,
    over ``layout``'s shards when the model is sharded) unless
    ``optimizer_fn(masters)`` builds another (a grouped or finetune
    optimizer; the clip is then each group's)."""
    named = {n: local(p) for n, p in model.named_parameters()
             if p.device.type != 'meta'}
    params = {n: p if p.dtype == torch.float32
              else p.detach().float().clone() for n, p in named.items()}
    ema = {n: p.detach().clone() for n, p in params.items()}
    optimizer = (optimizer_fn(params) if optimizer_fn is not None
                 else build_optimizer(params, cfg, model, layout))
    accumulator = (GradAccumulator(cfg.grad_accum_steps,
                                   list(params.values()))
                   if cfg.grad_accum_steps > 1 else None)
    return TrainState(0, params, ema, optimizer, accumulator)


def flow_loss(model: nn.Module, transport: Transport,
              batch: Dict[str, Tensor],
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, Tensor]] = None
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean flow-matching loss of a train-mode forward on ``batch``
    (feature, grid, mask, label, size). t, x0 and the label drops are drawn
    from ``generator`` (t, x0, then the drops) unless ``draws`` gives them
    (``t``, ``x0``, ``drop_ids``)."""
    draws = draws or {}

    def model_fn(xt, t):
        return model(xt, t, batch['label'], batch['grid'], batch['mask'],
                     batch.get('size'), train=True,
                     force_drop_ids=draws.get('drop_ids'),
                     generator=generator)

    out = transport.training_losses(model_fn, batch['feature'],
                                    mask=batch['mask'], generator=generator,
                                    t=draws.get('t'), x0=draws.get('x0'))
    return out['loss'].mean(), out


def make_step(model: nn.Module, loss_fn: LossFn, max_grad_norm: float = 1.0,
              ema_decay: float = 0.9999,
              required: Optional[Callable[..., Set[str]]] = None,
              layout=None
              ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The train step of ``model`` (the compute-dtype FiT) under
    ``loss_fn(model, batch, generator, draws, **kwargs) -> (loss,
    metrics)``: ``train_step(state, batch, generator=None, draws=None,
    **kwargs) -> (state, metrics)``, the keyword arguments passed on to the
    loss. It updates ``state`` in place: masters -> model, loss and
    backward, gradients -> fp32 masters, accumulation, clipping, AdamW,
    EMA. metrics: the loss function's, ``loss`` and ``grad_norm`` (of this
    micro-step's gradient), tensors on the device.

    A parameter that the backward leaves without a gradient raises: every
    parameter of the FiT is used, so a missing one means a detached output
    upstream of it. With ``required`` (``required(**kwargs)`` -> the names
    that must get one), a step may use a part of the model (an LwD
    segment): a parameter outside ``required`` that gets no gradient gets
    a zero one, as ``jax.grad`` gives it, so the norm, the clip and AdamW
    cover every parameter (Adam moves it by its momentum) as optax does.

    ``layout`` (a ``parallel.sharding.ShardedLayout``): ``model`` is
    sharded over its mesh; the step covers this rank's parameters (a
    pipeline stage's blocks; the local tensors of FSDP2's shards)."""
    names, model_params = zip(*(
        (n, p) for n, p in model.named_parameters()
        if p.device.type != 'meta'))
    mesh = None if layout is None else layout.mesh

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Tensor]] = None, **kwargs):
        masters = list(state.params.values())
        pairs = [(p, m) for p, m in zip(model_params, masters)
                 if local(p) is not m]
        if pairs:
            with torch.no_grad():
                torch._foreach_copy_([p for p, _ in pairs],
                                     [m for _, m in pairs])
        model.zero_grad(set_to_none=True)
        with row_shard_draws(generator, mesh):
            loss, metrics = loss_fn(model, batch, generator, draws, **kwargs)
        loss.backward()
        need = set(names) if required is None else required(**kwargs)
        missing = [n for n, p in zip(names, model_params)
                   if p.grad is None and n in need]
        if missing:
            raise RuntimeError(
                f'no gradient for {len(missing)} parameters ({missing[:5]}'
                '...): an output upstream of them has no grad_fn')
        grads = [torch.zeros_like(local(p), dtype=torch.float32)
                 if p.grad is None else local(p.grad).float()
                 for p in model_params]
        model.zero_grad(set_to_none=True)
        world = process_count()
        if layout is not None:
            grads = layout.reduce_grads(names, grads)
            norm = layout.global_norm(names, grads)
        else:
            if world > 1:
                grads = _all_reduce_mean(grads)
            norm = global_norm(grads)
        clip_norm = norm
        if state.accumulator is not None:
            grads = state.accumulator.update(grads)
            clip_norm = None
            if grads is not None and layout is not None:
                clip_norm = layout.global_norm(names, grads)
        if grads is not None:
            if not isinstance(state.optimizer, MultiTransform):
                clip_by_global_norm(grads, max_grad_norm, clip_norm)
            for m, g in zip(masters, grads):
                m.grad = g
            state.optimizer.step()  # a MultiTransform clips each group
            for m in masters:
                m.grad = None
            grads = None  # the fp32 gradients go before the EMA's update
        update_ema(state.ema_params, state.params, ema_decay)
        state.step += 1
        metrics = dict(metrics, loss=loss.detach(), grad_norm=norm)
        if world > 1:
            scalar = [k for k, v in metrics.items()
                      if k != 'grad_norm' and v.dim() == 0
                      and v.is_floating_point()]
            means = all_reduce_mean_(torch.stack(
                [metrics[k].float() for k in scalar]))
            metrics.update(zip(scalar, means.unbind()))
        return state, metrics

    return train_step


def _all_reduce_mean(grads: List[Tensor]) -> List[Tensor]:
    """The processes' mean of the fp32 gradients, through one flat
    all-reduce; views of that buffer, shaped as ``grads``."""
    flat = all_reduce_mean_(torch.cat([g.reshape(-1) for g in grads]))
    return [part.view_as(g) for part, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(model: nn.Module, transport: Transport,
                    max_grad_norm: float = 1.0, ema_decay: float = 0.9999,
                    layout=None
                    ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The flow-matching train step (``make_step`` over ``flow_loss``);
    metrics: ``loss`` and ``grad_norm``."""
    def loss_fn(model, batch, generator, draws):
        loss, _ = flow_loss(model, transport, batch, generator, draws)
        return loss, {}
    return make_step(model, loss_fn, max_grad_norm, ema_decay,
                     layout=layout)
