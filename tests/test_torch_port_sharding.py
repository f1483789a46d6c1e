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
  - checkpoints: a sharded run resumed under its mesh is bit-identical to
    the uninterrupted one; process 0 writes the one-process layout, which
    a one-process Trainer loads and whose one-process counterpart loads
    into the sharded trainer, bit for bit;
  - JAX's refusals: the pipeline with ddpm, int8 or a sequence mesh, a
    stage axis beside another model axis, a batch that does not split
    into the data shards x pp_microbatches; CAME under sharding (not
    ported).
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
from fitv2_tpu_torch.parallel import comms, mesh as pmesh
from fitv2_tpu_torch.parallel.pipeline import make_pipelined_forward
from fitv2_tpu_torch.parallel.sharding import ShardedLayout, shard_model
from fitv2_tpu_torch.train import lwd_train_step as lts
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.train.lwd_trainer import LwDTrainer, LwDTrainerConfig
from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig

from test_torch_port_parallel import (
    GB, TINY, _first_batch, _flat, _free_port, rel_l2)

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


def fit_case(inputs, case, kw=TINY, accum=1, mask=True, root_only=False,
             microbatches=M, step=True):
    """Forward and ``accum`` train micro-steps of the FiT under ``case``
    (``root_only``: FSDP2 on the root alone): this rank's output rows, the
    step's metrics and collectives, the one-process state (process 0) and
    the local parameter bytes."""
    mesh = pmesh.build_mesh(pmesh.MeshConfig(**case))
    model = _model(FiT, kw, inputs['init'][kw['adaln_type']])
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
    state = tts.create_train_state(layout.model, tts.OptimizerConfig(
        learning_rate=LR, grad_accum_steps=accum))
    train_step = tts.make_train_step(compute, create_transport(),
                                     ema_decay=EMA, layout=layout)
    with comms.CollectiveLog() as log:
        for _ in range(accum):
            _, metrics = train_step(state, batch, draws=draws)
    res.update(loss=float(metrics['loss']),
               grad_norm=float(metrics['grad_norm']),
               counts=dict(log.counts()), bytes=_local_bytes(state),
               full=layout.full_state_dict(state))
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
    return out


def cli_run(inputs, root):
    """cli/train.py under fsdp 2 x tensor 2 (the YAML's accelerate keys)
    for 2 steps from a TINY config: the trainer's mesh, and the losses."""
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
                           os.path.join(root, 'cli_run'), '--max-steps',
                           '2', '--no-resume', '--device', 'cpu'])
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
    tr.train(max_steps=2, resume=False)
    return dict(mesh=tr.mesh.shape, batch=tr.cfg.global_batch_size,
                losses=losses, precision=tr.cfg.mixed_precision)


def refusals(inputs, root):
    """The mesh-level refusals, as JAX's trainer raises them."""
    out = {}
    for name, kw in (('stage_fsdp', dict(mesh_data=1, mesh_stage=2,
                                         mesh_fsdp=2)),
                     ('microbatches', dict(mesh_data=2, mesh_stage=2,
                                           pp_microbatches=3)),
                     ('came', dict(mesh_data=1, mesh_fsdp=4,
                                   optimizer='came'))):
        try:
            _trainer(inputs, os.path.join(root, 'refuse'), **kw)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f'{type(e).__name__}: {e}'
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
    out['cli'] = cli_run(inputs, root)
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


def jax_fit_run(case, params, batch, draws, kw=TINY, accum=1, mask=True,
                microbatches=M, step=True):
    """JAX's sharded forward and ``accum`` train steps (make_train_step
    with the pipelined forward under stage), jitted over the 4-device
    mesh as its Trainer lays the state out."""
    import jax
    import jax.numpy as jnp
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

    tx = jts.make_optimizer(jts.OptimizerConfig(
        learning_rate=LR, grad_accum_steps=accum))
    state = jts.create_train_state(params, tx)
    state = jax.device_put(state, _state_shardings(mesh, state))
    train_step = jts.make_train_step(jm, Given(), tx, ema_decay=EMA,
                                     apply_fn=apply_fn)

    def run(state, jb):
        out = apply_fn(state.params, jb['feature'], t, jb['label'],
                       jb['grid'], jb['mask'], jb['size'])
        if not step:
            return out, state, {}
        metrics = []
        for _ in range(accum):
            state, m = train_step(state, jb, jax.random.PRNGKey(0))
            metrics.append(m)
        return out, state, metrics[-1]

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
    for adaln, kw in (('lora', TINY), ('normal', NORMAL)):
        params[adaln] = jax.tree_util.tree_map(
            np.asarray, jax_tree(FiT(**kw), seed=3))
        init[adaln] = state_dict_from_jax(
            {'params': params[adaln]}, depth=2, num_heads=4,
            adaln_type=adaln)
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
    pool = ProcessPoolExecutor(3, mp_context=mp.get_context('spawn'))
    futures = [pool.submit(_jax_job, job) for job in jobs]
    inputs = dict(shards=shards, init=init, draws=draws, batch=batch,
                  one_ckpt=os.path.join(root, 'one', 'checkpoints',
                                        'checkpoint-2', 'train_state.pt'))
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
    jax_runs = dict(f.result() for f in futures)
    pool.shutdown()
    _join(ctx)
    ranks = [torch.load(os.path.join(root, f'rank{r}.pt'),
                        weights_only=False) for r in range(WORLD)]
    yield dict(root=root, inputs=inputs, ranks=ranks, jax=jax_runs,
               lwd_model=(jm, lkw), rms_kw=rms_kw)
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
    assert a['step'] == b['step']
    for key in ('params', 'ema_params'):
        assert a[key].keys() == b[key].keys()
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ('mu', 'nu'):
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


def test_refusals(sharded, tmp_path):
    got = sharded['ranks'][0]['refusals']
    assert 'data axis only' in got['stage_fsdp']
    assert 'pp_microbatches=3' in got['microbatches']
    assert 'slice 9c' in got['came']
    inputs = sharded['inputs']
    with pytest.raises(ValueError, match='flow objective'):
        _trainer(inputs, str(tmp_path), mesh_stage=2, objective='ddpm')
    stage2 = pmesh.Mesh(dict(data=1, stage=2, fsdp=1, sequence=1, tensor=1))
    with pytest.raises(ValueError, match='parity path'):
        make_pipelined_forward(FiT(**TINY, gemm_precision='int8'), stage2, 2)
    with pytest.raises(ValueError, match='SP or PP'):
        make_pipelined_forward(FiT(**TINY, sequence_mesh=stage2), stage2, 2)


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
