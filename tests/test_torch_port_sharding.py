"""PyTorch port, model sharding (parallel/sharding.py, parallel/pipeline.py
and their users): one spawn of four gloo CPU processes (``_worker``; each
rank through ``parallel.init_distributed`` on torchrun's variables) runs
every axis, and the results are held against one process and against the
JAX package's own sharded functions on four of the eight virtual CPU
devices (weights through ``ckpt.state_dict_from_jax`` /
``lwd_state_from_jax``, draws passed in as tensors). Relative L2, fp32:

  - the forward and one train step (loss, gradient norm, Adam's first
    moment, updated parameters) within 1e-5 of JAX's sharded run, under
    fsdp 4, fsdp 2 x tensor 2, data 2 x tensor 2, sequence 4 (FiT and
    FiTLwD) and data 2 x stage 2 with pp_microbatches 2 (the padded mask;
    the normal adaLN with mask None; two accumulated micro-steps);
  - an LwDTrainer batch under fsdp 2 x tensor 2 against JAX's segment
    update on that mesh (1e-5) and against one process (1e-6); the same
    with BFM-XL's RMSNorm q/k, whose shared weights' gradients the tensor
    ranks sum, and every rank gathering the same parameters;
  - a sequence axis that does not divide the heads runs unsplit and gives
    one process's step; a batch-only mesh leaves activations as they are;
  - every rank's parameter bytes: about 1/4 under fsdp 4, about 1/2 of
    the block stack under stage 2;
  - the collectives of one train step (``comms.CollectiveLog``):
    fsdp one all-gather a unit in forward, one a block in backward, one
    reduce-scatter a unit; tensor one all-reduce a block at proj and fc2;
    sequence four all-to-alls a block each way; stage one send or recv a
    microbatch each way. FSDP2 on the root alone (one gather of the whole
    model) fails the check;
  - CAME (two steps, weight decay 0.1, from a randomised init) within
    1e-5 of JAX's sharded CAME under fsdp 2 x tensor 2 (TINY with an
    adaLN-LoRA rank of 1) and data 2 x stage 2 (TINY): the parameters'
    change, m and the factored row/column state; under sequence 4 within
    1e-5 of one process. Under fsdp 2 the label table's 11 rows split 6 / 5 and
    each block's adaLN-LoRA fc1 (one row: JAX's (64, 1) kernel, its (1,)
    bias) leaves fsdp rank 1 an empty chunk;
  - the grouped optimizer (CAME with decay, AdamW without, split by the
    JAX leaf's rank) under fsdp 2 x tensor 2 against JAX's
    ``multi_transform``: each group's clip norm at both steps, the
    parameters and the CAME group's state;
  - checkpoints: a sharded run resumed under its mesh is bit-identical to
    the uninterrupted one; process 0 writes the one-process layout, which
    a one-process Trainer loads and whose one-process counterpart loads
    into the sharded trainer, bit for bit, with AdamW and with CAME;
  - the inline eval hook under fsdp 2 x tensor 2, from a one-process
    checkpoint's EMA: process 0's preview equals the one-process hook's
    bit for bit, and no other rank writes one;
  - JAX's refusals: the pipeline with ddpm, int8 or a sequence mesh, a
    stage axis beside another model axis, a batch that does not split
    into the data shards x pp_microbatches; CAME under fsdp 4 trains.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fitv2_tpu_torch.flow import create_transport
from fitv2_tpu_torch.models import FiT, FiTLwD
from fitv2_tpu_torch.models.bfm import split_decay_param_labels
from fitv2_tpu_torch.parallel import comms, mesh as pmesh
from fitv2_tpu_torch.parallel.pipeline import make_pipelined_forward
from fitv2_tpu_torch.parallel.sharding import ShardedLayout, shard_model
from fitv2_tpu_torch.train import lwd_train_step as lts
from fitv2_tpu_torch.sample import SamplingConfig
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.train.eval_hook import InlineEvalHook
from fitv2_tpu_torch.train.lwd_trainer import LwDTrainer, LwDTrainerConfig
from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig

from test_torch_port_parallel import (
    GB, SAMPLE, TINY, _first_batch, _flat, _free_port, rel_l2)

WORLD, LR, EMA, M = 4, 1e-4, 0.9, 2
TOL = 1e-5
DEADLINE_S = 240
CASES = {'fsdp4': dict(data=1, fsdp=4),
         'fsdp2_tp2': dict(data=1, fsdp=2, tensor=2),
         'dp2_tp2': dict(data=2, tensor=2),
         'seq4': dict(data=1, sequence=4),
         'dp2_pp2': dict(data=2, stage=2)}
NORMAL = dict(TINY, adaln_type='normal', adaln_lora_dim=None)
HEADS2 = dict(TINY, num_heads=2)  # sequence 4 does not divide 2 heads
# CAME's runs: TINY with an adaLN-LoRA rank of 1 (one row: fsdp rank 1
# holds an empty chunk of it), two steps with weight decay
CAME_KW = dict(TINY, adaln_lora_dim=1)
CAME = dict(optimizer='came', learning_rate=LR, weight_decay=0.1)
ADAM_GROUP = dict(learning_rate=2e-3, max_grad_norm=0.5)
# name -> (mesh, model, its init); under stage JAX's pipeline_opt_shardings
# splits a stacked bias' (D,) r_col over the stages, which D = 1 refuses
CAME_CASES = {'came_fsdp2_tp2': (CASES['fsdp2_tp2'], CAME_KW, 'came'),
              'came_dp2_pp2': (CASES['dp2_pp2'], TINY, 'lora'),
              'came_seq4': (CASES['seq4'], CAME_KW, 'came')}
HOOK = dict(SAMPLE, dtype=torch.float32)
# the LwD model: test_torch_port_lwd_train.py's 'plain' variant, its
# seed (the segment stream's and JAX's step key) and learning rate
LWD_SEGMENT, LWD_SEED, LWD_LR = 1, 3, 1e-3


def _rows(mesh, n=GB):
    index, count = pmesh.batch_sharding(mesh)
    return slice(index * n // count, (index + 1) * n // count)


def _model(cls, kw, init):
    model = cls(**kw)
    model.load_state_dict(init)
    return model


def _local_bytes(state):
    return sum(t.numel() * t.element_size() for t in state.params.values())


def _fsdp_root_only(model, mesh):
    """FSDP2 on the root alone, over ``mesh``'s fsdp axis: one gather of
    the whole model, the rule the collective check refuses."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    shapes = {n: p.shape for n, p in model.named_parameters()}
    fully_shard(model, mesh=mesh.device_mesh['fsdp'],
                mp_policy=MixedPrecisionPolicy(reduce_dtype=torch.float32,
                                               cast_forward_inputs=False))
    return model, ShardedLayout(mesh, model, {}, {}, shapes)


def _grouped(model, layout=None):
    """The decay grouping's optimizer (of the masters): CAME with decay, AdamW
    without, labelled by the JAX leaf's rank (``model``: one process's)."""
    labels = split_decay_param_labels(FiT(**CAME_KW))
    return lambda masters: tts.make_grouped_optimizer(
        masters, lambda n, _: labels[n],
        {'decay': tts.OptimizerConfig(**CAME),
         'no_decay': tts.OptimizerConfig(**ADAM_GROUP)}, model, layout)


def fit_case(inputs, case, kw=TINY, accum=1, mask=True, root_only=False,
             microbatches=M, step=True, init=None, opt=None, steps=1,
             grouped=False):
    """Forward and ``accum`` train micro-steps (``steps`` times) of the FiT
    (from ``inputs['init'][init]``) under ``case`` (``root_only``: FSDP2
    on the root alone; ``opt``: the OptimizerConfig's fields; ``grouped``:
    ``_grouped``'s optimizer): this rank's output rows, the step's metrics
    and collectives, each grouped step's clip norms, the one-process state
    (process 0) and the local parameter bytes."""
    mesh = pmesh.build_mesh(pmesh.MeshConfig(**case))
    model = _model(FiT, kw, inputs['init'][init or kw['adaln_type']])
    compute, layout = _fsdp_root_only(model, mesh) if root_only else \
        shard_model(model, mesh, pp_microbatches=microbatches)
    rows = _rows(mesh)
    batch = {k: v[rows] for k, v in inputs['batch'].items()}
    if not mask:
        batch['mask'] = None
    draws = {k: torch.from_numpy(v[rows]) for k, v in inputs['draws'].items()}
    with torch.no_grad():
        out = compute(batch['feature'], draws['t'], batch['label'],
                      batch['grid'], batch['mask'], batch['size'],
                      force_drop_ids=draws['drop_ids'])
    if hasattr(compute, 'reshard'):  # FSDP2 keeps the root gathered
        compute.reshard()
    res = dict(out=out, rows=(rows.start, rows.stop))
    if not step:
        return res
    state = tts.create_train_state(
        layout.model, tts.OptimizerConfig(**{
            **dict(learning_rate=LR, grad_accum_steps=accum), **(opt or {})}),
        _grouped(layout.model, layout) if grouped else None, layout)
    train_step = tts.make_train_step(compute, create_transport(),
                                     ema_decay=EMA, layout=layout)
    norms = []
    with comms.CollectiveLog() as log:
        for _ in range(steps):
            for _ in range(accum):
                _, metrics = train_step(state, batch, draws=draws)
            if grouped:
                norms.append({k: float(v) for k, v in
                              state.optimizer.norms.items()})
    res.update(loss=float(metrics['loss']),
               grad_norm=float(metrics['grad_norm']),
               counts=dict(log.counts()), bytes=_local_bytes(state),
               norms=norms, full=layout.full_state_dict(state))
    return res


def lwd_seq_case(inputs):
    """FiTLwD under sequence 4: segment ``LWD_SEGMENT``'s forward and one
    reflow update with JAX's draws."""
    from fitv2_tpu_torch.models.fit_lwd import FiTLwD as PFiTLwD
    mesh = pmesh.build_mesh(pmesh.MeshConfig(data=1, sequence=4))
    model = _model(PFiTLwD, inputs['lwd_kw'], inputs['lwd_init'])
    compute, layout = shard_model(model, mesh)
    b = inputs['lwd_batch4']
    with torch.no_grad():
        out, _ = compute.forward_run_layer(
            b['feature'], inputs['lwd_t'], b['label'], LWD_SEGMENT,
            b['grid'], b['mask'], b['size'])
    state = tts.create_train_state(layout.model, tts.OptimizerConfig(
        learning_rate=LWD_LR))
    step = lts.make_lwd_train_step(compute, ema_decay=EMA, repa_weight=0.5,
                                   layout=layout)
    with comms.CollectiveLog() as log:
        _, metrics = step(state, b, LWD_SEGMENT,
                          draws=inputs['lwd_draws4'])
    return dict(out=out, loss=float(metrics['loss']),
                counts=dict(log.counts()), full=layout.full_state_dict(state))


def shared_enc_case(inputs, mesh=None):
    """The shared-encoder LwD model (randomised from a seed) under
    ``mesh``'s sequence axis, or alone: segment 0's velocity and REPA
    projection on the batch of 4, and the gradient of their squares'
    sum (reduced over the axis), flat in the one-process order."""
    from fitv2_tpu_torch.models import FiTLwDSharedEncSepDec
    torch.manual_seed(7)
    model = FiTLwDSharedEncSepDec(**inputs['shared_kw'])
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    layout = None
    if mesh is not None:
        model, layout = shard_model(model, mesh)
    b = inputs['lwd_batch4']
    out, rep = model.forward_run_layer(
        b['feature'], inputs['lwd_t'], b['label'], 0, b['grid'], b['mask'],
        b['size'])
    ((out.float() ** 2).sum() + (rep.float() ** 2).sum()).backward()
    names, params = zip(*model.named_parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
             for p in params]  # other segments and the mid blocks: none
    if layout is not None:
        grads = layout.reduce_grads(names, grads)
    return dict(out=out.detach(), rep=rep.detach(), grads=_flat(grads))


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self, batch_size, max_steps, resume_step, seed=0,
                         process_index=0, process_count=1):
        per = batch_size // process_count
        rows = slice(process_index * per, (process_index + 1) * per)
        return iter([{k: v[rows] for k, v in b.items()}
                     for b in self.batches[resume_step:max_steps]])


def lwd_trainer_run(inputs, out, jax_draws, fsdp=2, tensor=2, kind='lwd'):
    """One LwDTrainer batch (one segment update) of ``kind`` ('lwd': the
    plain variant, 'rms': its RMSNorm-q/k twin) on the batch of 8; with
    ``jax_draws`` the update takes JAX's draws (this rank's rows).
    Returns the one-process state (process 0) and every parameter as
    this rank gathers it."""
    torch.manual_seed(0)
    model = _model(FiTLwD, inputs[f'{kind}_kw'], inputs[f'{kind}_init'])
    tr = LwDTrainer(model, LwDTrainerConfig(
        global_batch_size=GB, max_steps=1, segments_per_step=1,
        learning_rate=LWD_LR, ema_decay=EMA, seed=LWD_SEED, output_dir=out,
        checkpointing_steps=100, device='cpu', mesh_fsdp=fsdp,
        mesh_tensor=tensor), loader=ListLoader([inputs['lwd_batch8']]))
    if jax_draws:
        inner, rows = tr._train_step, _rows(tr.mesh)

        draws = inputs[f'{kind}_draws8']

        def replay(state, batch, k, generator=None, draws=draws):
            assert k == LWD_SEGMENT
            return inner(state, batch, k, draws={
                n: v[rows] for n, v in draws.items()})
        tr._train_step = replay
    state = tr.train(resume=False)
    if tr.layout is None:
        return state.state_dict(), dict(state.params)
    return tr.layout.full_state_dict(state), {
        n: tr.layout.to_full(n, state.params.get(n)) for n in tr.layout.names}


def _trainer(inputs, out, **kw):
    cfg = dict(data_path=inputs['shards'], target_len=16,
               global_batch_size=GB, num_workers=1, loader_backend='python',
               max_steps=4, learning_rate=LR, lr_warmup_steps=0,
               mixed_precision='bf16', seed=5, device='cpu',
               output_dir=out, checkpointing_steps=100, log_every=1)
    cfg.update(kw)
    torch.manual_seed(0)
    return Trainer(_model(FiT, TINY, inputs['init']['lora']),
                   TrainerConfig(**cfg))


def checkpoint_runs(inputs, root, rank):
    """Trainer runs under fsdp 2 x tensor 2 (bf16 compute): uninterrupted,
    then interrupted and resumed; and the one-process checkpoint
    restored."""
    mesh = dict(mesh_data=1, mesh_fsdp=2, mesh_tensor=2)
    out = {}
    whole = _trainer(inputs, os.path.join(root, 'whole'), max_steps=3,
                     **mesh)
    out['whole'] = whole.layout.full_state_dict(whole.train(resume=False))
    part = os.path.join(root, 'part')
    _trainer(inputs, part, checkpointing_steps=2, **mesh).train(
        max_steps=2, resume=False)
    out['saved'] = sorted(os.listdir(os.path.join(part, 'checkpoints')))
    resumed = _trainer(inputs, part, max_steps=3, **mesh)
    out['resumed'] = resumed.layout.full_state_dict(
        resumed.train(resume=True))
    # the one-process run's checkpoint-2 into this mesh
    tr = _trainer(inputs, os.path.join(root, f'restore{rank}'), **mesh)
    state = tr.init_state()
    tr.layout.load_full_state_dict(state, torch.load(
        _wait_for(inputs['one_ckpt']), weights_only=True, mmap=True))
    out['from_one'] = tr.layout.full_state_dict(state)
    # CAME: this mesh's checkpoint, and the one-process one restored here
    came = dict(mesh, optimizer='came')
    tr = _trainer(inputs, os.path.join(root, 'came'), max_steps=2, **came)
    out['came'] = tr.layout.full_state_dict(tr.train(resume=False))
    tr = _trainer(inputs, os.path.join(root, f'came_restore{rank}'), **came)
    state = tr.init_state()
    tr.layout.load_full_state_dict(state, torch.load(
        _wait_for(inputs['one_came_ckpt']), weights_only=True, mmap=True))
    out['came_from_one'] = tr.layout.full_state_dict(state)
    return out


def hook_run(inputs, root, rank):
    """The inline eval hook of a trainer under fsdp 2 x tensor 2 whose
    state is the one-process checkpoint's: an evaluation at step 2, each
    rank writing under its own folder."""
    tr = _trainer(inputs, os.path.join(root, f'hook_run{rank}'),
                  mesh_data=1, mesh_fsdp=2, mesh_tensor=2)
    tr.state = tr.init_state()
    tr.layout.load_full_state_dict(tr.state, torch.load(
        inputs['one_ckpt'], weights_only=True, mmap=True))
    hook = InlineEvalHook(tr.one_process_model, SamplingConfig(**HOOK),
                          every=2, seed=3, device='cpu',
                          out_dir=os.path.join(root, 'hook', f'rank{rank}'))
    hook.attach(tr.gathered_ema)
    hook(2, {})


def cli_run(inputs, root, came=False):
    """cli/train.py under fsdp 2 x tensor 2 (the YAML's accelerate keys)
    for 2 steps from a TINY config (``came``: with ``--came``): the
    trainer's mesh and optimizer, and the losses."""
    import yaml
    from fitv2_tpu_torch.cli import train as cli
    cfg = os.path.join(root, 'cli.yaml')
    if dist.get_rank() == 0:
        with open(cfg + '.tmp', 'w') as f:
            yaml.safe_dump({
                'diffusion': {'network_config': {
                    'target': 'fitv2_tpu.models.fit.FiT', 'params': TINY}},
                'data': {'params': {'train': {
                    'data_path': inputs['shards'], 'target_len': 16,
                    'loader': {'batch_size': GB // WORLD,
                               'num_workers': 1}}}},
                'accelerate': {'mesh_fsdp': 2, 'mesh_tensor': 2,
                               'lr_warmup_steps': 0}}, f)
        os.replace(cfg + '.tmp', cfg)
    args = cli.parse_args(['--cfgdir', _wait_for(cfg), '--output-dir',
                           os.path.join(root, 'cli_came' if came
                                        else 'cli_run'), '--max-steps',
                           '2', '--no-resume', '--device', 'cpu']
                          + (['--came'] if came else []))
    from fitv2_tpu_torch.utils.config import load_config
    torch.manual_seed(0)
    tr = cli.build_trainer(load_config(args.cfgdir), args)
    tr.cfg.loader_backend = 'python'
    losses, inner = [], tr._train_step

    def step(*a, **k):
        out = inner(*a, **k)
        losses.append(float(out[1]['loss']))
        return out
    tr._train_step = step
    state = tr.train(max_steps=2, resume=False)
    return dict(mesh=tr.mesh.shape, batch=tr.cfg.global_batch_size,
                losses=losses, precision=tr.cfg.mixed_precision,
                optimizer=type(state.optimizer).__name__)


def refusals(inputs, root):
    """The mesh-level refusals, as JAX's trainer raises them."""
    out = {}
    for name, kw in (('stage_fsdp', dict(mesh_data=1, mesh_stage=2,
                                         mesh_fsdp=2)),
                     ('microbatches', dict(mesh_data=2, mesh_stage=2,
                                           pp_microbatches=3))):
        try:
            _trainer(inputs, os.path.join(root, 'refuse'), **kw)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f'{type(e).__name__}: {e}'
    # CAME under fsdp 4, once refused, trains
    tr = _trainer(inputs, os.path.join(root, 'came_fsdp4'), mesh_data=1,
                  mesh_fsdp=4, optimizer='came')
    out['came'] = tr.layout.full_state_dict(tr.train(max_steps=2,
                                                     resume=False))
    return out


# -- the four ranks -----------------------------------------------------------

def _worker(rank, port, root, inputs):
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)
    assert pmesh.init_distributed('cpu') == (rank, WORLD)
    out = {name: fit_case(inputs, case) for name, case in CASES.items()}
    out['pp_normal_none'] = fit_case(inputs, CASES['dp2_pp2'], kw=NORMAL,
                                     mask=False, microbatches=4, step=False)
    out['pp_accum'] = fit_case(inputs, CASES['dp2_pp2'], accum=2)
    out['fsdp_root'] = fit_case(inputs, CASES['fsdp4'], root_only=True)
    for name, (case, kw, init) in CAME_CASES.items():
        out[name] = fit_case(inputs, case, kw=kw, init=init, opt=CAME,
                             steps=2)
    out['grouped_fsdp2_tp2'] = fit_case(inputs, CASES['fsdp2_tp2'],
                                        kw=CAME_KW, init='came', steps=2,
                                        grouped=True)
    out['seq_unsplit'] = fit_case(inputs, CASES['seq4'], kw=HEADS2)
    data4 = pmesh.build_mesh(pmesh.MeshConfig(data=4))
    x = torch.zeros(2, 16, 8)
    out['batch_only_pin'] = pmesh.constrain_sequence(x, data4) is x
    seq4 = pmesh.build_mesh(pmesh.MeshConfig(data=1, sequence=4))
    out['seq_none'] = (pmesh.sequence_sharding(seq4, 16, 2) is None,
                       pmesh.sequence_sharding(seq4, 18, 4) is None,
                       pmesh.constrain_sequence(torch.zeros(1, 16, 2),
                                                seq4).shape)
    inputs.update(torch.load(_wait_for(os.path.join(root, 'late.pt')),
                             weights_only=False))
    out['lwd_seq4'] = lwd_seq_case(inputs)
    out['shared_seq4'] = shared_enc_case(inputs, pmesh.build_mesh(
        pmesh.MeshConfig(data=1, sequence=4)))
    out['lwd_trainer_jax'], _ = lwd_trainer_run(
        inputs, os.path.join(root, 'lwd_j'), jax_draws=True)
    out['lwd_trainer_gen'], _ = lwd_trainer_run(
        inputs, os.path.join(root, 'lwd_g'), jax_draws=False)
    out['lwd_rms'], out['lwd_rms_here'] = lwd_trainer_run(
        inputs, os.path.join(root, 'lwd_rms'), jax_draws=True, kind='rms')
    out['ckpt'] = checkpoint_runs(inputs, root, rank)
    hook_run(inputs, root, rank)
    out['cli'] = cli_run(inputs, root)
    out['cli_came'] = cli_run(inputs, root, came=True)
    out['refusals'] = refusals(inputs, root)
    torch.save(out, os.path.join(root, f'rank{rank}.pt'))
    dist.destroy_process_group()


def _wait_for(path):
    """``path`` once the parent has written it (renamed into place)."""
    while not os.path.exists(path):
        time.sleep(0.05)
    return path


def _spawn(root, inputs):
    return mp.spawn(_worker, args=(_free_port(), root, inputs),
                    nprocs=WORLD, join=False)


def _join(ctx):
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f'the {WORLD} ranks did not finish in {DEADLINE_S} s')


# -- JAX's sharded runs -------------------------------------------------------

def _jax_mesh(case):
    import jax
    from fitv2_tpu.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(**case), devices=jax.devices()[:4])


def _state_shardings(mesh, state):
    """JAX's Trainer.state_shardings for ``mesh``."""
    from types import SimpleNamespace
    from fitv2_tpu.train.trainer import Trainer as JTrainer
    fake = SimpleNamespace(cfg=SimpleNamespace(
        mesh_stage=mesh.shape['stage']), mesh=mesh)
    return JTrainer.state_shardings(fake, state)


def _norm_recorder():
    """An optax transformation that passes the updates on and keeps their
    global norm as its state: first in a group's chain, the norm that the
    group's clip takes."""
    import optax

    def init(params):
        import jax.numpy as jnp
        return jnp.zeros((), jnp.float32)

    def update(updates, state, params=None):
        return updates, optax.global_norm(updates)
    return optax.GradientTransformation(init, update)


def _recorded(opt_state, label):
    """The norm ``_norm_recorder`` kept in group ``label`` of a
    ``multi_transform`` state."""
    inner = opt_state.inner_states[label]
    return getattr(inner, 'inner_state', inner)[0]


def jax_fit_run(case, params, batch, draws, kw=TINY, accum=1, mask=True,
                microbatches=M, step=True, opt=None, steps=1,
                grouped=False):
    """JAX's sharded forward and ``steps`` x ``accum`` train steps
    (make_train_step with the pipelined forward under stage), jitted over
    the 4-device mesh as its Trainer lays the state out; ``grouped``: a
    ``multi_transform`` of CAME with decay and AdamW without, split by
    ``split_decay_param_labels``, each group's clip norm recorded."""
    import jax
    import jax.numpy as jnp
    import optax
    from fitv2_tpu.flow import transport as jtransport
    from fitv2_tpu.models.fit import FiT as JFiT
    from fitv2_tpu.parallel.pipeline import make_pipelined_forward as jpp
    from fitv2_tpu.train import train_step as jts
    mesh = _jax_mesh(case)
    stage = mesh.shape['stage'] > 1
    pin = not stage and any(mesh.shape[a] > 1
                            for a in ('data', 'fsdp', 'sequence'))
    jm = JFiT(**kw, dtype=jnp.float32, sequence_mesh=mesh if pin else None)
    t, x0, drop = (jnp.asarray(draws[k]) for k in ('t', 'x0', 'drop_ids'))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if not mask:
        jb['mask'] = None
    if stage:
        pfwd = jpp(jm, mesh, microbatches, train=True)

        def apply_fn(p, x, tt, y, grid, m, size, rngs=None):
            return pfwd(p, x, tt, y, grid, m, size, force_drop_ids=drop)
    else:
        def apply_fn(p, x, tt, y, grid, m, size, rngs=None):
            return jm.apply({'params': p}, x, tt, y, grid, m, size,
                            train=True, force_drop_ids=drop)

    class Given(jtransport.Transport):
        def sample(self, rng_key, x):
            return t, x0, x

    if grouped:
        from fitv2_tpu.models import bfm as jbfm
        tx = optax.multi_transform({
            label: optax.chain(_norm_recorder(), jts.make_optimizer(
                jts.OptimizerConfig(**cfg)))
            for label, cfg in (('decay', CAME), ('no_decay', ADAM_GROUP))},
            jbfm.split_decay_param_labels(params))
    else:
        tx = jts.make_optimizer(jts.OptimizerConfig(**{
            **dict(learning_rate=LR, grad_accum_steps=accum), **(opt or {})}))
    state = jts.create_train_state(params, tx)
    state = jax.device_put(state, _state_shardings(mesh, state))
    train_step = jts.make_train_step(jm, Given(), tx, ema_decay=EMA,
                                     apply_fn=apply_fn)

    def run(state, jb):
        out = apply_fn(state.params, jb['feature'], t, jb['label'],
                       jb['grid'], jb['mask'], jb['size'])
        if not step:
            return out, state, {}
        metrics, norms = [], []
        for _ in range(steps):
            for _ in range(accum):
                state, m = train_step(state, jb, jax.random.PRNGKey(0))
                metrics.append(m)
            if grouped:
                norms.append({label: _recorded(state.opt_state, label)
                              for label in ('decay', 'no_decay')})
        return out, state, dict(metrics[-1], norms=norms)

    from test_torch_port_lwd_train import NO_OPT
    with mesh:
        out, state, metrics = jax.jit(run, compiler_options=NO_OPT)(state,
                                                                     jb)
    return jax.device_get((out, state, metrics))


def _port_names(tree, kw):
    from fitv2_tpu_torch.ckpt import state_dict_from_jax
    return state_dict_from_jax({'params': tree}, depth=kw['depth'],
                               num_heads=kw['num_heads'],
                               adaln_type=kw['adaln_type'])


def _adam(opt_state):
    from fitv2_tpu_torch.ckpt.convert import _find_state
    return _find_state(opt_state, 'mu', 'nu', 'count')


def _jax_setup():
    """tests/conftest.py's JAX settings, in a process of its own."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_default_matmul_precision', 'highest')


def _jax_job(job):
    """One of JAX's sharded runs in a pool process: (name, result)."""
    _jax_setup()
    name, kind, kw = job
    if kind == 'fit':
        return name, jax_fit_run(**kw)
    return name, jax_lwd_run(**kw)


def jax_lwd_run(case, batch, t4=None, name='plain'):
    """JAX's FiTLwD (variant ``name``) on ``case``'s 4-device mesh: one
    reflow update on segment LWD_SEGMENT from the variant's initial state
    (and, with ``t4``, the segment's forward), jitted over the mesh."""
    import jax
    import jax.numpy as jnp
    from fitv2_tpu.train import lwd_train_step as jlts
    from test_torch_port_lwd_train import NO_OPT, TX, variant
    jm, _, _, _, init = variant(name)
    mesh = _jax_mesh(case)
    m = jm.clone(sequence_mesh=mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax.device_put(init, _state_shardings(mesh, init))
    step = jlts.make_lwd_train_step(m, TX, EMA, 0.5)

    def run(state, jb):
        new, metrics = step(state, jb, jax.random.PRNGKey(LWD_SEED),
                            LWD_SEGMENT)
        if t4 is None:
            return None, new, metrics
        fwd, _ = m.apply({'params': state.params}, jb['feature'],
                         jnp.asarray(t4), jb['label'], LWD_SEGMENT,
                         jb['grid'], jb['mask'], jb['size'],
                         method=m.forward_run_layer)
        return fwd, new, metrics
    with mesh:
        return jax.device_get(jax.jit(run, compiler_options=NO_OPT)(
            state, jb))


@pytest.fixture(scope='module')
def sharded(tmp_path_factory):
    """Inputs, the four ranks' results, JAX's sharded runs (three pool
    processes, while the ranks work) and the one-process references."""
    import jax
    from concurrent.futures import ProcessPoolExecutor
    from fitv2_tpu_torch.ckpt import lwd_state_from_jax, state_dict_from_jax
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    from test_torch_port_int8_lwd import jax_tree
    from test_torch_port_lwd_train import (
        SHARED, _batch, jax_step_draws, variant)

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp('sharding'))
    shards = os.path.join(root, 'fit')
    make_synthetic_latent_shards(shards, n=32, target_len=16, n_classes=10,
                                 seed=1)
    params = {}
    init = {}
    for key, kw in (('lora', TINY), ('normal', NORMAL), ('came', CAME_KW)):
        params[key] = jax.tree_util.tree_map(
            np.asarray, jax_tree(FiT(**kw), seed=3))
        init[key] = state_dict_from_jax(
            {'params': params[key]}, depth=2, num_heads=4,
            adaln_type=kw['adaln_type'])
    rng = np.random.default_rng(4)
    draws = dict(t=rng.uniform(0.05, 0.95, GB).astype(np.float32),
                 x0=rng.standard_normal((GB, 16, 16)).astype(np.float32),
                 drop_ids=np.array([0, 1, 0, 0, 1, 0, 0, 0], np.int32))
    batch = _first_batch(shards)
    # copies: the spawn below moves the tensors' storage to shared memory
    np_batch = {k: v.numpy().copy() for k, v in batch.items()}
    common = dict(params=params['lora'], batch=np_batch, draws=draws)
    jobs = [(name, 'fit', dict(common, case=case))
            for name, case in CASES.items()]
    jobs += [('pp_normal_none', 'fit', dict(
        common, case=CASES['dp2_pp2'], params=params['normal'], kw=NORMAL,
        mask=False, microbatches=4, step=False)),
        ('pp_accum', 'fit', dict(common, case=CASES['dp2_pp2'], accum=2))]
    for name in ('came_fsdp2_tp2', 'came_dp2_pp2'):
        case, kw, key = CAME_CASES[name]
        jobs.append((name, 'fit', dict(common, params=params[key], kw=kw,
                                       case=case, opt=CAME, steps=2)))
    jobs.append(('grouped_fsdp2_tp2', 'fit', dict(
        common, params=params['came'], kw=CAME_KW, steps=2,
        case=CASES['fsdp2_tp2'], grouped=True)))
    pool = ProcessPoolExecutor(3, mp_context=mp.get_context('spawn'))
    futures = [pool.submit(_jax_job, job) for job in jobs]
    inputs = dict(shards=shards, init=init, draws=draws, batch=batch,
                  one_ckpt=os.path.join(root, 'one', 'checkpoints',
                                        'checkpoint-2', 'train_state.pt'),
                  one_came_ckpt=os.path.join(root, 'one_came', 'checkpoints',
                                             'checkpoint-2',
                                             'train_state.pt'))
    ctx = _spawn(root, inputs)
    # while the ranks run the FiT cases: the LwD model, its batches and
    # JAX's draws of segment LWD_SEGMENT, then the one-process checkpoint
    # that the sharded trainer restores
    jm, lparams, _, lkw, linit = variant('plain')
    rms_jm, rms_params, _, rms_kw, rms_init = variant('rms')
    assert lts.SegmentSampler(jm.number_of_perflow, LWD_SEED)() == \
        LWD_SEGMENT
    lb4, lb8 = (_batch(jm, seed=20, batch=b) for b in (4, 8))
    t4 = np.linspace(0.55, 0.9, 4).astype(np.float32)
    futures += [pool.submit(_jax_job, job) for job in (
        ('lwd_seq4', 'lwd', dict(case=CASES['seq4'], batch=lb4, t4=t4)),
        ('lwd_fsdp2_tp2', 'lwd', dict(case=CASES['fsdp2_tp2'],
                                      batch=lb8)),
        ('lwd_rms_fsdp2_tp2', 'lwd', dict(case=CASES['fsdp2_tp2'],
                                          batch=lb8, name='rms')))]
    late = dict(
        lwd_kw=lkw, shared_kw=SHARED,
        lwd_init=lwd_state_from_jax(linit.params, FiTLwD(**lkw)),
        lwd_batch4={k: torch.from_numpy(v.copy()) for k, v in lb4.items()},
        lwd_batch8={k: torch.from_numpy(v.copy()) for k, v in lb8.items()},
        lwd_t=torch.from_numpy(t4.copy()),
        lwd_draws4=jax_step_draws(jm, lparams, 0, LWD_SEGMENT,
                                  lb4['feature'].shape, seed=LWD_SEED),
        lwd_draws8=jax_step_draws(jm, lparams, 0, LWD_SEGMENT,
                                  lb8['feature'].shape, seed=LWD_SEED),
        rms_kw=rms_kw,
        rms_init=lwd_state_from_jax(rms_init.params, FiTLwD(**rms_kw)),
        rms_draws8=jax_step_draws(rms_jm, rms_params, 0, LWD_SEGMENT,
                                  lb8['feature'].shape, seed=LWD_SEED))
    torch.save(late, os.path.join(root, 'late.tmp'))
    os.replace(os.path.join(root, 'late.tmp'), os.path.join(root, 'late.pt'))
    inputs.update(late)
    _trainer(inputs, os.path.join(root, 'one'), checkpointing_steps=2
             ).train(max_steps=2, resume=False)
    _trainer(inputs, os.path.join(root, 'one_came'), checkpointing_steps=2,
             optimizer='came').train(max_steps=2, resume=False)
    jax_runs = dict(f.result() for f in futures)
    pool.shutdown()
    _join(ctx)
    ranks = [torch.load(os.path.join(root, f'rank{r}.pt'),
                        weights_only=False) for r in range(WORLD)]
    yield dict(root=root, inputs=inputs, ranks=ranks, jax=jax_runs,
               lwd_model=(jm, lkw), rms_kw=rms_kw, params=params)
    torch.set_num_threads(prev)


# -- the checks ----------------------------------------------------------------

def _assemble(ranks, name):
    """The global batch's output from the ranks' rows."""
    out = torch.zeros(GB, *ranks[0][name]['out'].shape[1:])
    for res in ranks:
        r = res[name]
        out[slice(*r['rows'])] = r['out']
    return out


def _full(res):
    return res['full']


def _params(sd, names):
    return _flat(sd['params'][n] for n in names)


def _mu(sd):
    return _flat(v['mu'] for _, v in sorted(sd['optimizer']['state']
                                            .items()))


@pytest.mark.parametrize('name', list(CASES) + ['pp_accum'])
def test_forward_and_step_match_jax_sharded(sharded, name):
    ranks, jrun = sharded['ranks'], sharded['jax'][name]
    jout, jstate, jmetrics = jrun
    assert rel_l2(_assemble(ranks, name), jout) <= TOL
    r0 = ranks[0][name]
    for res in ranks:  # every rank reports the step's global metrics
        np.testing.assert_allclose(res[name]['loss'], r0['loss'], rtol=1e-6)
    np.testing.assert_allclose(r0['loss'], float(jmetrics['loss']),
                               rtol=TOL)
    np.testing.assert_allclose(r0['grad_norm'],
                               float(jmetrics['grad_norm']), rtol=TOL)
    names = [n for n, _ in FiT(**TINY).named_parameters()]
    full = _full(r0)
    jparams = _port_names(jstate.params, TINY)
    assert rel_l2(_params(full, names), _flat(jparams[n] for n in names)) \
        <= TOL
    adam = _adam(jstate.opt_state)
    jmu = _port_names(adam.mu, TINY)
    assert rel_l2(_mu(full), _flat(jmu[n] for n in names)) <= TOL
    jema = _port_names(jstate.ema_params, TINY)
    assert rel_l2(_flat(full['ema_params'][n] for n in names),
                  _flat(jema[n] for n in names)) <= TOL
    if name == 'pp_accum':  # the second micro-step applied the mean
        assert full['accumulator']['gradient_step'] == 1
        assert full['optimizer']['param_groups'][0]['count'] == 1


def test_pipeline_normal_adaln_without_mask_matches_jax(sharded):
    jout = sharded['jax']['pp_normal_none'][0]
    assert rel_l2(_assemble(sharded['ranks'], 'pp_normal_none'), jout) \
        <= TOL


def test_pipeline_padded_tokens_are_zero(sharded):
    mask = sharded['inputs']['batch']['mask']
    assert (mask == 0).any()
    out = _assemble(sharded['ranks'], 'dp2_pp2')
    assert out[mask == 0].abs().max() == 0.0


def test_unsplit_sequence_axis_equals_one_process(sharded):
    r0 = sharded['ranks'][0]
    assert r0['batch_only_pin']
    assert r0['seq_none'] == (True, True, torch.Size([1, 4, 2]))
    inputs = sharded['inputs']
    model = _model(FiT, HEADS2, inputs['init']['lora'])
    state = tts.create_train_state(model, tts.OptimizerConfig(
        learning_rate=LR))
    step = tts.make_train_step(model, create_transport(), ema_decay=EMA)
    draws = {k: torch.from_numpy(v) for k, v in inputs['draws'].items()}
    _, metrics = step(state, inputs['batch'], draws=draws)
    res = r0['seq_unsplit']
    np.testing.assert_allclose(res['loss'], float(metrics['loss']),
                               rtol=1e-6)
    np.testing.assert_allclose(res['grad_norm'], float(metrics['grad_norm']),
                               rtol=1e-6)
    mu = _flat(state.optimizer.state[p]['mu'] for p in state.params.values())
    assert rel_l2(_mu(res['full']), mu) <= 1e-6


def test_lwd_sequence_parallel_matches_jax(sharded):
    jm, lkw = sharded['lwd_model']
    from fitv2_tpu_torch.ckpt import lwd_state_from_jax
    jfwd, jstate, jmetrics = sharded['jax']['lwd_seq4']
    res = sharded['ranks'][0]['lwd_seq4']
    assert rel_l2(res['out'], jfwd) <= TOL
    np.testing.assert_allclose(res['loss'], float(jmetrics['loss']),
                               rtol=TOL)
    model = FiTLwD(**lkw)
    names = [n for n, _ in model.named_parameters()]
    jp = lwd_state_from_jax(jstate.params, model)
    assert rel_l2(_params(res['full'], names), _flat(jp[n] for n in names)) \
        <= TOL
    jmu = lwd_state_from_jax(_adam(jstate.opt_state).mu, model)
    assert rel_l2(_mu(res['full']), _flat(jmu[n] for n in names)) <= TOL


def test_shared_encoder_sequence_parallel_equals_one_process(sharded):
    one = shared_enc_case(sharded['inputs'])
    for res in sharded['ranks']:
        got = res['shared_seq4']
        assert rel_l2(got['out'], one['out']) <= 1e-6
        assert rel_l2(got['rep'], one['rep']) <= 1e-6
        assert rel_l2(got['grads'], one['grads']) <= 1e-6


def test_lwd_trainer_fsdp_tensor_matches_jax_and_one_process(sharded):
    jm, lkw = sharded['lwd_model']
    from fitv2_tpu_torch.ckpt import lwd_state_from_jax
    _, jstate, _ = sharded['jax']['lwd_fsdp2_tp2']
    res = sharded['ranks'][0]['lwd_trainer_jax']
    model = FiTLwD(**lkw)
    names = [n for n, _ in model.named_parameters()]
    assert res['step'] == 1
    jp = lwd_state_from_jax(jstate.params, model)
    assert rel_l2(_params(res, names), _flat(jp[n] for n in names)) <= TOL
    jmu = lwd_state_from_jax(_adam(jstate.opt_state).mu, model)
    assert rel_l2(_mu(res), _flat(jmu[n] for n in names)) <= TOL
    # against one process, the (seed, step) generator's draws
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        ref, _ = lwd_trainer_run(sharded['inputs'], out, False, fsdp=1,
                                 tensor=1)
    gen = sharded['ranks'][0]['lwd_trainer_gen']
    assert rel_l2(_mu(gen), _mu(ref)) <= 1e-6
    assert rel_l2(_params(gen, names), _params(ref, names)) <= 1e-6


def test_lwd_trainer_rmsnorm_qk_fsdp_tensor_matches_jax(sharded):
    """BFM-XL's RMSNorm q/k: one (Dh,) weight that every head shares, so
    each tensor rank's gradient covers its own heads only. Under fsdp 2 x
    tensor 2 the update equals JAX's sharded one, the norms' weights
    included, and every rank gathers the same parameters."""
    from fitv2_tpu_torch.ckpt import lwd_state_from_jax
    kw = sharded['rms_kw']
    _, jstate, _ = sharded['jax']['lwd_rms_fsdp2_tp2']
    ranks = sharded['ranks']
    res = ranks[0]['lwd_rms']
    model = FiTLwD(**kw)
    names = [n for n, _ in model.named_parameters()]
    norms = [n for n in names if n.endswith(('q_norm.weight',
                                             'k_norm.weight'))]
    assert len(norms) == 2 * kw['depth']
    jp = lwd_state_from_jax(jstate.params, model)
    jmu = lwd_state_from_jax(_adam(jstate.opt_state).mu, model)
    assert rel_l2(_params(res, names), _flat(jp[n] for n in names)) <= TOL
    assert rel_l2(_mu(res), _flat(jmu[n] for n in names)) <= TOL
    index = {n: i for i, n in enumerate(names)}
    mu = res['optimizer']['state']
    assert rel_l2(_flat(mu[index[n]]['mu'] for n in norms),
                  _flat(jmu[n] for n in norms)) <= TOL
    for other in ranks[1:]:
        here = other['lwd_rms_here']
        for n in names:
            assert torch.equal(here[n], ranks[0]['lwd_rms_here'][n]), n


def test_zero_init_gradient_is_the_final_linear_alone(sharded):
    """At the FiT's zero init (adaLN-zero blocks, a zero final layer) any
    loss of the output has a gradient in the final layer's linear alone:
    a first-step gradient check at that init cannot see how the trunk is
    sharded (chip_smoke.py's phase 18 randomises the zero layers first)."""
    inputs = sharded['inputs']
    b, t = inputs['batch'], torch.from_numpy(inputs['draws']['t'])
    torch.manual_seed(0)
    model = FiT(**TINY)
    out = model(b['feature'], t, b['label'], b['grid'], b['mask'], b['size'])
    ((out - b['feature']) ** 2).sum().backward()
    moved = {n for n, p in model.named_parameters()
             if p.grad is not None and p.grad.any()}
    assert moved == {'final_layer.linear.weight', 'final_layer.linear.bias'}


def test_parameter_bytes_per_rank(sharded):
    ranks = sharded['ranks']
    inputs = sharded['inputs']
    full = sum(t.numel() * 4 for t in inputs['init']['lora'].values())
    blocks = sum(t.numel() * 4 for n, t in inputs['init']['lora'].items()
                 if n.startswith('blocks.'))
    for res in ranks:
        assert res['fsdp4']['bytes'] <= 0.27 * full
        # the blocks' split layers a quarter, the rest a half
        assert res['fsdp2_tp2']['bytes'] < 0.5 * full
        # stage 2: one block of two, the rest whole
        assert res['dp2_pp2']['bytes'] == pytest.approx(
            full - blocks / 2, rel=0.01)
    assert sum(r['fsdp4']['bytes'] for r in ranks) == full


def expected_collectives(name, depth=2, microbatches=M, stage=0):
    """One train step's c10d collectives on one rank under ``name``'s
    mesh (FSDP2 units: the blocks and the root)."""
    if name == 'fsdp4':  # + the norm's and the metrics' all-reduces
        return {'all_gather': 2 * depth + 1, 'reduce_scatter': depth + 1,
                'all_reduce': 2}
    if name in ('dp2_tp2',):  # proj, fc2 fwd; qkv, fc1, adaLN bwd; adaLN
        return {'all_reduce': 5 * depth + 3, 'all_gather': depth}
    if name == 'seq4':  # q, k, v and back, each way; the output gather
        return {'all_to_all': 8 * depth, 'all_gather': 1, 'all_reduce': 2}
    if name == 'dp2_pp2':  # a microbatch each way; the output broadcast
        return {'send': microbatches, 'recv': microbatches, 'broadcast': 1,
                'all_reduce': 4}
    raise KeyError(name)


def signature_holds(counts, name):
    return counts == expected_collectives(name)


@pytest.mark.parametrize('name', ['fsdp4', 'dp2_tp2', 'seq4', 'dp2_pp2'])
def test_collective_signature(sharded, name):
    for res in sharded['ranks']:
        assert signature_holds(res[name]['counts'], name), \
            (name, res[name]['counts'])


def test_collective_check_fails_on_fsdp_at_the_root_only(sharded):
    for res in sharded['ranks']:
        counts = res['fsdp_root']['counts']
        assert counts['all_gather'] == 1 and counts['reduce_scatter'] == 1
        assert not signature_holds(counts, 'fsdp4')
        # the same numbers all the same: only the collectives differ
        np.testing.assert_allclose(res['fsdp_root']['loss'],
                                   res['fsdp4']['loss'], rtol=1e-6)


def _equal_states(a, b):
    """Two one-process train states bit for bit: the weights, the EMA and
    every tensor of the optimizer's state (AdamW's moments, CAME's)."""
    assert a['step'] == b['step']
    for key in ('params', 'ema_params'):
        assert a[key].keys() == b[key].keys()
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys(), i
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a['optimizer']['param_groups'][0]['count'] == \
        b['optimizer']['param_groups'][0]['count']


def test_sharded_resume_is_bit_identical(sharded):
    ck = sharded['ranks'][0]['ckpt']
    assert ck['saved'] == ['checkpoint-2']
    _equal_states(ck['whole'], ck['resumed'])
    assert all(r['ckpt']['whole'] is None for r in sharded['ranks'][1:])


def test_checkpoints_cross_meshes(sharded):
    root, inputs = sharded['root'], sharded['inputs']
    ck = sharded['ranks'][0]['ckpt']
    # process 0 wrote the one-process layout; a one-process trainer loads
    # it: weights, moments and EMA as the sharded run held them
    path = os.path.join(root, 'whole', 'checkpoints', 'checkpoint-3',
                        'train_state.pt')
    one = _trainer(inputs, os.path.join(root, 'one_loads'))
    state = one.init_state()
    state.load_state_dict(torch.load(path, weights_only=True))
    _equal_states(state.state_dict(), ck['whole'])
    # the one-process checkpoint restored under fsdp 2 x tensor 2
    _equal_states(ck['from_one'], torch.load(inputs['one_ckpt'],
                                             weights_only=True))


def test_came_checkpoints_cross_meshes(sharded):
    """CAME's state in a checkpoint written under fsdp 2 x tensor 2 is the
    one-process CAME's layout, which a one-process CAME Trainer loads bit
    for bit; and a one-process CAME checkpoint restored under the mesh
    gathers back bit for bit."""
    root, inputs = sharded['root'], sharded['inputs']
    ck = sharded['ranks'][0]['ckpt']
    assert set(ck['came']['optimizer']['state'][0]) == {
        'm', 'r_row', 'r_col', 's_row', 's_col'}
    path = os.path.join(root, 'came', 'checkpoints', 'checkpoint-2',
                        'train_state.pt')
    one = _trainer(inputs, os.path.join(root, 'one_came_loads'),
                   optimizer='came')
    state = one.init_state()
    state.load_state_dict(torch.load(path, weights_only=True))
    _equal_states(state.state_dict(), ck['came'])
    _equal_states(ck['came_from_one'], torch.load(inputs['one_came_ckpt'],
                                                  weights_only=True))


CAME_KEYS = ('m', 'r_row', 'r_col', 's_row', 's_col', 'r_full')


def _came_from_jax(opt_state, kw=CAME_KW, grouped=False):
    """JAX's CAME state of a FiT(**kw) (of the decay group under
    ``grouped``) in the one-process CAME's state-dict layout."""
    from fitv2_tpu_torch.ckpt import came_state_from_jax
    model = FiT(**kw)
    masters = dict(model.named_parameters())
    opt = (_grouped(model)(masters).optimizers['decay'] if grouped else
           tts.build_optimizer(masters, tts.OptimizerConfig(**CAME), model))
    came_state_from_jax(opt_state, model, opt)
    return opt.state_dict()['state']


def _came_close(got, want):
    """Each of CAME's statistics, over every leaf, within TOL."""
    assert got.keys() == want.keys()
    for k in CAME_KEYS:
        a = [got[i][k] for i in sorted(got) if k in got[i]]
        b = [want[i][k] for i in sorted(want) if k in want[i]]
        assert len(a) == len(b), k
        if b or k in CAME_KEYS[:5]:  # a group may hold no 1-D leaf
            assert rel_l2(_flat(a), _flat(b)) <= TOL, k


def _moved(sd, init):
    names = list(init)
    return _flat(sd[n] - init[n] for n in names)


@pytest.mark.parametrize('name', ['came_fsdp2_tp2', 'came_dp2_pp2'])
def test_came_matches_jax_sharded(sharded, name):
    """Two CAME steps (decay 0.1) under the mesh against JAX's CAME on the
    same mesh: the loss, the parameters' change, and m, r_row, r_col,
    s_row, s_col, r_full in the one-process layout."""
    _, jstate, jmetrics = sharded['jax'][name]
    _, kw, key = CAME_CASES[name]
    res = sharded['ranks'][0][name]
    full, init = _full(res), sharded['inputs']['init'][key]
    assert full['step'] == 2
    assert full['optimizer']['param_groups'][0]['count'] == 2
    np.testing.assert_allclose(res['loss'], float(jmetrics['loss']),
                               rtol=TOL)
    jp = _port_names(jstate.params, kw)
    assert rel_l2(_moved(full['params'], init), _moved(jp, init)) <= TOL
    _came_close(full['optimizer']['state'],
                _came_from_jax(jstate.opt_state, kw))


def test_came_sequence_parallel_equals_one_process(sharded):
    inputs = sharded['inputs']
    init = inputs['init']['came']
    model = _model(FiT, CAME_KW, init)
    state = tts.create_train_state(model, tts.OptimizerConfig(**CAME))
    step = tts.make_train_step(model, create_transport(), ema_decay=EMA)
    draws = {k: torch.from_numpy(v) for k, v in inputs['draws'].items()}
    for _ in range(2):
        step(state, inputs['batch'], draws=draws)
    one = state.state_dict()
    full = _full(sharded['ranks'][0]['came_seq4'])
    assert rel_l2(_moved(full['params'], init),
                  _moved(one['params'], init)) <= TOL
    _came_close(full['optimizer']['state'], one['optimizer']['state'])


def test_grouped_optimizer_matches_jax_sharded(sharded):
    """make_grouped_optimizer under fsdp 2 x tensor 2 against JAX's
    multi_transform on that mesh: each group's clip norm at both steps
    (the same bits on every rank), the parameters' change and the CAME
    group's state."""
    _, jstate, jmetrics = sharded['jax']['grouped_fsdp2_tp2']
    ranks = sharded['ranks']
    res = ranks[0]['grouped_fsdp2_tp2']
    assert len(res['norms']) == len(jmetrics['norms']) == 2
    for ours, theirs in zip(res['norms'], jmetrics['norms']):
        assert ours.keys() == {'decay', 'no_decay'}
        for label, norm in ours.items():
            np.testing.assert_allclose(norm, float(theirs[label]), rtol=TOL)
    assert all(r['grouped_fsdp2_tp2']['norms'] == res['norms']
               for r in ranks)
    full, init = _full(res), sharded['inputs']['init']['came']
    assert full['optimizer'].keys() == {'decay', 'no_decay'}
    jp = _port_names(jstate.params, CAME_KW)
    assert rel_l2(_moved(full['params'], init), _moved(jp, init)) <= TOL
    _came_close(full['optimizer']['decay']['state'],
                _came_from_jax(jstate.opt_state.inner_states['decay'],
                               grouped=True))


def test_inline_eval_hook_under_fsdp_tensor_equals_one_process(sharded,
                                                               tmp_path):
    """The hook of a trainer under fsdp 2 x tensor 2, its state restored
    from a one-process checkpoint: the preview equals the one-process
    hook's from that checkpoint's EMA bit for bit (the EMA's gather is
    exact), and process 0 alone writes it."""
    root, inputs = sharded['root'], sharded['inputs']
    sd = torch.load(inputs['one_ckpt'], weights_only=True)
    hook = InlineEvalHook(FiT(**TINY), SamplingConfig(**HOOK), every=2,
                          seed=3, out_dir=str(tmp_path))
    hook.attach(lambda: sd['ema_params'])
    hook(2, {})
    want = np.load(tmp_path / 'preview_2.npz')['arr_0']
    got = np.load(os.path.join(root, 'hook', 'rank0', 'preview_2.npz'))[
        'arr_0']
    np.testing.assert_array_equal(got, want)
    assert sorted(os.listdir(os.path.join(root, 'hook'))) == ['rank0']


def test_cli_train_under_fsdp_and_tensor(sharded):
    res = [r['cli'] for r in sharded['ranks']]
    assert res[0]['mesh'] == dict(data=1, stage=1, fsdp=2, sequence=1,
                                  tensor=2)
    assert res[0]['batch'] == GB  # the YAML's per-process batch x 4
    assert res[0]['precision'] == 'bf16'  # the CLI's, as JAX's
    assert len(res[0]['losses']) == 2 and np.isfinite(res[0]['losses']).all()
    assert all(r['losses'] == res[0]['losses'] for r in res)
    saved = torch.load(os.path.join(sharded['root'], 'cli_run', 'checkpoints',
                                    'checkpoint-2', 'train_state.pt'),
                       weights_only=True)
    one = FiT(**TINY)
    assert {n: p.shape for n, p in one.named_parameters()} == \
        {n: t.shape for n, t in saved['params'].items()}


def test_cli_train_came_under_fsdp_and_tensor(sharded):
    """cli/train.py --came with the YAML's fsdp 2 x tensor 2 trains (it
    raised before CAME took a layout) and writes the one-process
    checkpoint with CAME's state."""
    res = [r['cli_came'] for r in sharded['ranks']]
    assert res[0]['optimizer'] == 'CAME'
    assert res[0]['mesh'] == dict(data=1, stage=1, fsdp=2, sequence=1,
                                  tensor=2)
    assert len(res[0]['losses']) == 2 and np.isfinite(res[0]['losses']).all()
    assert all(r['losses'] == res[0]['losses'] for r in res)
    saved = torch.load(os.path.join(sharded['root'], 'cli_came',
                                    'checkpoints', 'checkpoint-2',
                                    'train_state.pt'), weights_only=True)
    assert saved['optimizer']['param_groups'][0]['count'] == 2
    assert len(saved['optimizer']['state']) == 25  # TINY's JAX leaves


def test_refusals(sharded, tmp_path):
    got = sharded['ranks'][0]['refusals']
    assert 'data axis only' in got['stage_fsdp']
    assert 'pp_microbatches=3' in got['microbatches']
    came, init = got['came'], sharded['inputs']['init']['lora']
    assert came['step'] == 2
    assert came['optimizer']['param_groups'][0]['count'] == 2
    assert len(came['optimizer']['state']) == 25  # TINY's JAX leaves
    for n, t in came['params'].items():  # CAME under fsdp 4 trains
        assert torch.isfinite(t).all() and not torch.equal(t, init[n]), n
    inputs = sharded['inputs']
    with pytest.raises(ValueError, match='flow objective'):
        _trainer(inputs, str(tmp_path), mesh_stage=2, objective='ddpm')
    stage2 = pmesh.Mesh(dict(data=1, stage=2, fsdp=1, sequence=1, tensor=1))
    with pytest.raises(ValueError, match='parity path'):
        make_pipelined_forward(FiT(**TINY, gemm_precision='int8'), stage2, 2)
    with pytest.raises(ValueError, match='SP or PP'):
        make_pipelined_forward(FiT(**TINY, sequence_mesh=stage2), stage2, 2)


class _MeshAt(pmesh.Mesh):
    """A mesh without processes, seen from the rank at ``at``."""

    def __init__(self, shape, at):
        super().__init__(dict(dict(data=1, stage=1, fsdp=1, sequence=1,
                                   tensor=1), **shape))
        self.at = at

    def coordinate(self, axis):
        return self.at.get(axis, 0)


@pytest.mark.parametrize('shape', [dict(fsdp=2, tensor=2), dict(fsdp=4),
                                   dict(stage=2)])
def test_leaf_parts_tile_each_leaf(shape):
    """``JaxLeaf.part`` at every rank of a mesh (CAME_KW: fsdp's chunks of
    the one-row adaLN-LoRA fc1 and of the 11-row label table are uneven
    or empty): each part's entries of the whole leaf are what the
    checkpoint's ``from_full`` gives that rank, in JAX's layout, and the
    parts of the ranks along the axes that split the leaf tile it once."""
    import itertools
    from fitv2_tpu_torch.ckpt.convert import jax_leaves
    from fitv2_tpu_torch.parallel.pipeline import pipeline_param_shardings
    from fitv2_tpu_torch.parallel.sharding import tensor_parallel_
    torch.manual_seed(0)
    full = {n: p.detach() for n, p in FiT(**CAME_KW).named_parameters()}
    leaves = jax_leaves(FiT(**CAME_KW))
    tiled = {leaf.path: 0 for leaf in leaves}
    ranks = [dict(zip(shape, c))
             for c in itertools.product(*map(range, shape.values()))]
    for at in ranks:
        mesh = _MeshAt(shape, at)
        model = FiT(**CAME_KW)
        shapes = {n: p.shape for n, p in model.named_parameters()}
        owner = pipeline_param_shardings(mesh, model) if 'stage' in shape \
            else {}
        layout = ShardedLayout(mesh, model, tensor_parallel_(model, mesh),
                               owner, shapes)
        for leaf in leaves:
            part = leaf.part(shapes, layout)
            whole = leaf.to_jax([full[n] for n in leaf.names])
            axes = range(whole.dim())
            assert part.shape == tuple(whole.shape)
            assert set(part.split) == {a for n in leaf.names
                                       for a in layout.axes(n)}
            if not part.names:  # no block of the stack on this stage
                continue
            mine = leaf.to_jax([layout.from_full(n, full[n])
                                for n in part.names])
            assert torch.equal(part.take(whole, axes), mine), leaf.path
            if all(at[a] == 0 for a in shape if a not in part.split):
                # one rank of each group that the split axes leave alike
                tiled[leaf.path] = tiled[leaf.path] + part.place(
                    whole, axes, mine)
            if leaf.path == 'blocks/block/attn/qkv/kernel' and \
                    'tensor' in shape:  # columns: the heads', then FSDP2's
                assert part.axes == ((), (), ('tensor', 'fsdp'))
            if leaf.path == 'blocks/block/attn/proj/kernel' and \
                    'tensor' in shape:  # rows: the heads'; FSDP2's: out
                assert part.axes == ((), ('tensor',), ('fsdp',))
    for leaf in leaves:
        assert torch.equal(tiled[leaf.path], leaf.to_jax(
            [full[n] for n in leaf.names])), leaf.path
    if 'fsdp' in shape:  # fsdp's last rank: the LoRA row is not its
        last = _MeshAt(shape, dict(fsdp=shape['fsdp'] - 1))
        model = FiT(**CAME_KW)
        layout = ShardedLayout(last, model, tensor_parallel_(model, last),
                               {}, {n: p.shape for n, p in
                                    model.named_parameters()})
        lora = next(lf for lf in leaves
                    if lf.path == 'blocks/block/adaLN_modulation/fc1/kernel')
        assert lora.part(layout.shapes, layout).index[-1].numel() == 0


def test_param_shardings_follow_jax_rule():
    """fit_param_shardings against JAX's _spec_for_param (fsdp 2, tensor
    2): every parameter is fsdp-split; each kernel JAX splits over tensor
    outside adaLN is split here too, and here the tensor split adds only
    the column layers' biases and the blocks' adaLN output layers."""
    from fitv2_tpu.parallel.mesh import _spec_for_param
    from fitv2_tpu_torch.ckpt.convert import jax_leaves
    from fitv2_tpu_torch.parallel import fit_param_shardings, replicated
    model = FiT(**TINY)
    mesh = pmesh.Mesh(dict(data=1, stage=1, fsdp=2, sequence=1, tensor=2))
    table = fit_param_shardings(mesh, model)
    params = dict(model.named_parameters())
    split = 0
    for leaf in jax_leaves(model):
        shape = leaf.to_jax([params[n].detach() for n in leaf.names]).shape
        jax_tensor = 'tensor' in tuple(_spec_for_param(leaf.path, shape, 2,
                                                       2))
        for n in leaf.names:
            assert 'fsdp' in table[n], n
            if jax_tensor and 'adaLN' not in leaf.path:
                assert 'tensor' in table[n], (leaf.path, n)
            if 'tensor' in table[n]:
                split += 1
                assert jax_tensor or n.endswith('.bias'), (leaf.path, n)
    assert split == 2 * 8  # a block: 5 weights, 3 column biases
    assert replicated(mesh) == ()
