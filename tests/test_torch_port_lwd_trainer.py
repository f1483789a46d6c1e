"""PyTorch port, slice 7b: ``train/lwd_trainer.py`` (against JAX's
``LwDTrainer``, and its resume against its own uninterrupted run), async
checkpoint saves in both trainers, and ``cli/train_lwd`` (each recipe, the
config's dtype, a JAX-exported distillation teacher, the checkpoint that
``cli/sample_lwd`` reads).

The models, draws and tolerances are test_torch_port_lwd_train.py's. JAX's
``LwDTrainer`` shards its batch over the 8 virtual devices (batch 8 here);
its orbax checkpoints are stubbed out. Tolerances beyond those: a resumed
port run against its uninterrupted run, and an async checkpoint file
against a blocking one: bit for bit; the CLI teacher's velocity against
JAX's FiT: 1e-5 relative.
"""

import copy
import os
import time

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from fitv2_tpu.ckpt.torch_export import export_fit_state_dict, \
    save_safetensors
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.train import lwd_train_step as jlts
from fitv2_tpu.train import lwd_trainer as jlwd_trainer

from fitv2_tpu_torch.ckpt import CheckpointManager
from fitv2_tpu_torch.cli import sample_lwd as cli_sample
from fitv2_tpu_torch.cli import train_lwd as cli
from fitv2_tpu_torch.data import make_synthetic_latent_shards
from fitv2_tpu_torch.models import FiT, FiTLwDSharedEncSepDec
from fitv2_tpu_torch.train import lwd_train_step as lts
from fitv2_tpu_torch.train.lwd_trainer import LwDTrainer, LwDTrainerConfig
from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig

from test_torch_port_lwd import randomize
from test_torch_port_lwd_train import (
    BATCH, EMA, KW, LR, NO_OPT, SEED, SHARED, _batch, _check_metrics,
    _compare, _port_model, _rel, jax_step_draws, variant)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the trainer --------------------------------------------------------------

class ListLoader:
    """``train_dataloader`` over fixed numpy batches, from the resume step."""

    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self, batch_size, max_steps, resume_step, seed=0):
        return iter(self.batches[resume_step:max_steps])


def _config(out, **kw):
    cfg = dict(max_steps=2, learning_rate=LR, segments_per_step=2,
               log_every=1, checkpointing_steps=100, output_dir=out,
               seed=SEED, ema_decay=EMA, device='cpu')
    cfg.update(kw)
    return LwDTrainerConfig(**cfg)


class _NoCheckpoints:
    """Stands in for JAX's orbax CheckpointManager (its writes are not
    compared, and importing orbax takes seconds)."""

    def __init__(self, *args, **kwargs):
        pass

    def save(self, step, state):
        pass

    def wait(self):
        pass


def test_lwd_trainer_matches_jax(tmp_path, monkeypatch):
    """Two batches of two segment updates each (tests/test_lwd_trainer.py's
    loop): the segments, each update's draws (replayed from JAX's keys)
    and the final state and metrics as JAX's LwDTrainer's."""
    jm, params, pcls, kw, init = variant('repa')
    # JAX's trainer shards the batch over the 8 virtual devices
    batches = [_batch(jm, seed=10 + i, repa_dim=kw['repa_dim'], batch=8)
               for i in range(2)]
    jcfg = jlwd_trainer.LwDTrainerConfig(
        max_steps=2, learning_rate=LR, segments_per_step=2, log_every=1,
        checkpointing_steps=100, ema_decay=EMA,
        output_dir=str(tmp_path / 'jax'), seed=SEED)
    monkeypatch.setattr(jlwd_trainer, 'CheckpointManager', _NoCheckpoints)
    jtr = jlwd_trainer.LwDTrainer(jm, jcfg)
    jsegs = []
    step = jlts.make_lwd_train_step(jtr.model, jtr.tx, EMA, 0.5)
    for k in list(jtr._jitted):
        # JAX's step, jitted on one device (the trainer lays the state and
        # batch out over the 8 virtual ones: the same values, a slower
        # compile)
        def run(s, b, r, k=k, f=jax.jit(lambda s, b, r, k=k: step(
                s, b, r, k), compiler_options=NO_OPT)):
            jsegs.append(k)
            return f(*jax.device_get((s, b)), r)
        jtr._jitted[k] = run
    jmetrics = []
    jstate = jax.device_get(jtr.train(
        iter(batches), state=init, resume=False,
        metric_hook=lambda s, m: jmetrics.append(m)))

    model = _port_model(pcls, kw, init, jm)
    tr = LwDTrainer(model, _config(str(tmp_path / 'port')),
                    loader=ListLoader(batches))
    inner, segs = tr._train_step, []

    def replay(state, batch, k, generator=None, draws=None):
        segs.append(k)
        return inner(state, batch, k, draws=jax_step_draws(
            jm, params, state.step, k, tuple(batch['feature'].shape)))
    tr._train_step = replay
    metrics = []
    state = tr.train(resume=False,
                     metric_hook=lambda s, m: metrics.append(m))
    assert segs == jsegs and len(segs) == 4
    assert state.step == int(jstate.step) == 4
    assert len(metrics) == len(jmetrics) == 2
    for m, jm_ in zip(metrics, jmetrics):
        _check_metrics(m, {k: v for k, v in jm_.items()
                           if k != 'steps_per_sec'})
    _compare(state, jstate, init, model, 'trainer')


def _snapshot(state):
    snap = {k: {n: t.detach().clone() for n, t in getattr(state, k).items()}
            for k in ('params', 'ema_params')}
    snap['moments'] = copy.deepcopy(state.optimizer.state_dict())
    return snap


def _assert_bit_identical(state, snap):
    for key in ('params', 'ema_params'):
        for n, t in getattr(state, key).items():
            assert torch.equal(t, snap[key][n]), (key, n)
    a, b = state.optimizer.state_dict(), snap['moments']
    assert a['param_groups'] == b['param_groups']
    for i in a['state']:
        for key in ('mu', 'nu'):
            assert torch.equal(a['state'][i][key], b['state'][i][key])


@pytest.mark.parametrize('async_save', [False, True],
                         ids=['blocking', 'async'])
def test_lwd_trainer_resume_is_bit_identical(tmp_path, async_save):
    """4 batches of 3 segment updates uninterrupted against 2, a checkpoint
    (written in the background when async), and a new trainer resumed to
    4: the segment stream replayed, the loader from the resume step, and
    parameters, EMA and moments equal bit for bit."""
    jm, _, pcls, kw, _ = variant('plain')
    batches = [_batch(jm, seed=20 + i) for i in range(4)]

    def trainer(out):
        torch.manual_seed(0)
        return LwDTrainer(pcls(**kw), _config(
            out, max_steps=4, segments_per_step=3, checkpointing_steps=2,
            async_checkpointing=async_save), loader=ListLoader(batches))

    full = trainer(str(tmp_path / 'a'))
    segs_full = []
    inner = full._train_step
    full._train_step = lambda s, b, k, g=None, d=None: (
        segs_full.append(k), inner(s, b, k, g, d))[1]
    state_full = full.train(resume=False)
    snap = _snapshot(state_full)
    trainer(str(tmp_path / 'b')).train(max_steps=2, resume=False)
    resumed = trainer(str(tmp_path / 'b'))
    segs = []
    inner_b = resumed._train_step
    resumed._train_step = lambda s, b, k, g=None, d=None: (
        segs.append(k), inner_b(s, b, k, g, d))[1]
    state = resumed.train(max_steps=4)
    assert state.step == state_full.step == 12
    assert segs == segs_full[6:]
    _assert_bit_identical(state, snap)
    assert sorted(os.listdir(tmp_path / 'b' / 'checkpoints')) == [
        'checkpoint-2', 'checkpoint-4']


def test_lwd_trainer_preemption_writes_a_checkpoint_and_returns(tmp_path):
    """SIGTERM during a batch: the batch's segment updates finish, an
    (async) checkpoint of that batch is whole when train() returns, and
    the signal handler is put back."""
    import signal
    jm, _, pcls, kw, _ = variant('plain')
    out = str(tmp_path)
    before = signal.getsignal(signal.SIGTERM)

    def hook(step, m):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    tr = LwDTrainer(pcls(**kw), _config(out, max_steps=50,
                                        async_checkpointing=True),
                    loader=ListLoader([_batch(jm, seed=i) for i in range(5)]))
    state = tr.train(resume=False, metric_hook=hook)
    assert tr.preempted and state.step == 2 * 2
    assert os.listdir(os.path.join(out, 'checkpoints')) == ['checkpoint-2']
    assert CheckpointManager(os.path.join(out, 'checkpoints')).restore(
        2)['step'] == 4
    assert signal.getsignal(signal.SIGTERM) == before


def test_finetune_trainer_keeps_the_encoder(tmp_path):
    """tests/test_lwd_recipes.py's check through the port's trainer: two
    batches of finetune updates leave the shared encoder bit-equal and move
    the forecaster."""
    model = FiTLwDSharedEncSepDec(**SHARED)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every parameter N(0, 0.05), as randomize's
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    jm = JFiTLwD(**KW)  # the batches' grid
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tr = LwDTrainer(model, _config(str(tmp_path), segments_per_step=1),
                    recipe='finetune', finetune_mode='blend',
                    loader=ListLoader([_batch(jm, seed=i) for i in range(2)]))
    state = tr.train(resume=False)
    for n, p in state.params.items():
        if n.startswith('shared_rep_blocks.'):
            assert torch.equal(p, before[n]), n
    assert not torch.equal(state.params['mid_blocks.0.mlp.fc2.weight'],
                           before['mid_blocks.0.mlp.fc2.weight'])


def test_lwd_trainer_refuses_what_is_not_ported(tmp_path):
    _, _, pcls, kw, _ = variant('plain')
    # a 2-way fsdp axis does not resolve over one process (JAX's assert);
    # the sharded LwDTrainer is test_torch_port_sharding.py's
    with pytest.raises(AssertionError):
        LwDTrainer(pcls(**kw), _config(str(tmp_path), mesh_fsdp=2))
    with pytest.raises(ValueError, match='recipe'):
        LwDTrainer(pcls(**kw), _config(str(tmp_path)), recipe='gan')
    with pytest.raises(ValueError, match='finetune mode'):
        lts.make_lwd_finetune_step(FiTLwDSharedEncSepDec(**SHARED),
                                   mode='swap')


def test_bf16_compute_over_fp32_masters(tmp_path):
    """dtype 'bfloat16': a bf16 copy computes; masters, mu, nu and EMA stay
    fp32, and the masters move."""
    jm, _, pcls, kw, _ = variant('plain')
    model = pcls(**kw)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tr = LwDTrainer(model, _config(str(tmp_path), dtype='bfloat16'),
                    loader=ListLoader([_batch(jm, seed=i) for i in range(2)]))
    state = tr.train(resume=False)
    assert tr.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.params.values())
    for p in state.params.values():
        st = state.optimizer.state[p]
        assert st['mu'].dtype == st['nu'].dtype == torch.float32
    assert any(not torch.equal(p, before[n])
               for n, p in state.params.items())


# -- async checkpoint saves ---------------------------------------------------

def test_async_save_equals_a_blocking_save_and_rotation_waits(tmp_path,
                                                              monkeypatch):
    """The async file has the blocking file's bytes; the state mutated after
    ``save`` returns is not in it; rotation removes only whole checkpoints
    after the write in flight has finished."""
    state = {'step': 3, 'params': {'w': torch.arange(6.0).reshape(2, 3)},
             'optimizer': {'state': {0: {'mu': torch.ones(2, 3)}},
                           'param_groups': [{'count': 3, 'lr': 1e-3}]}}
    blocking = CheckpointManager(str(tmp_path / 'sync'))
    blocking.save(3, state)
    slow = threading_slow_save(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / 'async'), total_limit=1,
                            async_save=True)
    mgr.save(3, state)
    state['params']['w'].add_(100.0)  # after save returned
    assert os.listdir(mgr.ckpt_dir) != ['checkpoint-3']  # still writing
    mgr.save(4, state)  # waits for 3, rotates (1 kept), then writes 4
    assert 'checkpoint-3' in os.listdir(mgr.ckpt_dir)
    mgr.wait()
    assert sorted(os.listdir(mgr.ckpt_dir)) == ['checkpoint-4']
    assert slow['calls'] == 2
    state['params']['w'].sub_(100.0)
    mgr2 = CheckpointManager(str(tmp_path / 'async2'), async_save=True)
    mgr2.save(3, state)
    mgr2.wait()
    read = lambda m: open(os.path.join(m.path(3), 'train_state.pt'),
                          'rb').read()  # noqa: E731
    assert read(mgr2) == read(blocking)
    got = mgr2.restore(3)
    assert torch.equal(got['params']['w'], torch.arange(6.0).reshape(2, 3))


def threading_slow_save(monkeypatch):
    """torch.save that sleeps first: a write still in flight when save
    returns. Returns the call counter."""
    calls = {'calls': 0}
    real = torch.save

    def slow(obj, f, *a, **k):
        calls['calls'] += 1
        time.sleep(0.3)
        return real(obj, f, *a, **k)
    monkeypatch.setattr(torch, 'save', slow)
    return calls


def test_async_save_error_raises_at_wait(tmp_path, monkeypatch):
    def fail(*a, **k):
        raise OSError('disk full')
    monkeypatch.setattr(torch, 'save', fail)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {'w': torch.zeros(1)})
    with pytest.raises(RuntimeError, match='disk full'):
        mgr.wait()
    assert os.listdir(mgr.ckpt_dir) == []


def test_fit_trainer_async_checkpoints_resume_bit_identical(tmp_path):
    """The FiT ``Trainer`` with async_checkpointing: 4 steps against 2, an
    async checkpoint and a resume to 4, bit for bit."""
    from test_torch_port_train import TINY
    root = str(tmp_path / 'data')
    make_synthetic_latent_shards(root, n=16, target_len=16, n_classes=10)

    def trainer(out):
        torch.manual_seed(0)
        return Trainer(FiT(**TINY), TrainerConfig(
            data_path=root, target_len=16, global_batch_size=4,
            num_workers=1, max_steps=4, lr_schedule='constant',
            output_dir=out, checkpointing_steps=2, log_every=1, seed=0,
            device='cpu', loader_backend='python',
            async_checkpointing=True))

    snap = _snapshot(trainer(str(tmp_path / 'a')).train(resume=False))
    trainer(str(tmp_path / 'b')).train(max_steps=2, resume=False)
    state = trainer(str(tmp_path / 'b')).train(max_steps=4)
    _assert_bit_identical(state, snap)


# -- the CLI ------------------------------------------------------------------

def _write_config(tmp_path, target, params, data_dir):
    cfg = {'diffusion': {'network_config': {'target': target,
                                            'params': dict(params)}},
           'data': {'params': {'train': {
               'data_path': data_dir, 'target_len': 16,
               'loader': {'batch_size': 4, 'num_workers': 1}}}},
           'accelerate': {'learning_rate': 1e-3, 'max_train_steps': 2,
                          'checkpointing_steps': 2, 'seed': 0,
                          'lr_warmup_steps': 10}}
    path = str(tmp_path / 'cfg.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope='module')
def square_shards(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('square'))
    make_synthetic_latent_shards(root, n=8, target_len=16, n_classes=10,
                                 square=True)
    return root


def test_cli_train_lwd_then_sample_lwd(square_shards, tmp_path):
    """tests/test_lwd_recipes.py's CLI smoke in the port: 2 reflow steps on
    square shards write checkpoint-2 (3 segment updates a step), and
    cli/sample_lwd samples its EMA parameters."""
    kw = {k: v for k, v in KW.items() if k != 'class_dropout_prob'}
    cfg = _write_config(tmp_path, 'fitv2_tpu.models.fit_lwd.FiTLwD', kw,
                        square_shards)
    out = str(tmp_path / 'out')
    cli.main(['--cfgdir', cfg, '--output-dir', out, '--max-steps', '2',
              '--no-resume', '--device', 'cpu'])
    ckpt = os.path.join(out, 'checkpoints', 'checkpoint-2')
    assert os.listdir(os.path.dirname(ckpt)) == ['checkpoint-2']
    state = CheckpointManager(os.path.dirname(ckpt)).restore(2)
    assert state['step'] == 6
    npz = str(tmp_path / 'samples.npz')
    cli_sample.main(['--cfgdir', cfg, '--ckpt', ckpt, '--sampler', 'plain',
                     '--num-fid-samples', '2', '--per-device-batch', '2',
                     '--device', 'cpu', '--out', npz])
    arr = np.load(npz)['arr_0']
    assert arr.shape == (2, 8, 8, 4) and np.isfinite(arr).all()
    args = cli.parse_args(['--cfgdir', cfg])
    assert args.device == 'cuda' and args.resume
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            cli.main(['--cfgdir', cfg, '--output-dir', out])


def test_cli_builds_each_recipe_in_the_config_dtype(square_shards,
                                                   tmp_path):
    """The YAML's dtype is the compute dtype (the network built in fp32);
    the flags pick the recipe."""
    kw = dict(SHARED, dtype='bfloat16', multi_scale_indices=[1])
    cfg = _write_config(tmp_path, 'fitv2_tpu.models.bfm.BFM', kw,
                        square_shards)
    from fitv2_tpu_torch.utils.config import load_config
    with pytest.warns(UserWarning, match='multi_scale_indices'):
        tr = cli.build_trainer(load_config([cfg]), cli.parse_args(
            ['--cfgdir', cfg, '--finetune', 'residual', '--device', 'cpu']))
    assert tr.model.dtype == torch.bfloat16
    assert tr.master_model.dtype == torch.float32
    assert tr.optimizer_config.mu_dtype is None
    assert tr.optimizer_config.lr_schedule is None  # constant, no warmup


@pytest.mark.parametrize('cfg_scale', [0.0, 1.5], ids=['plain', 'cfg'])
def test_cli_distillation_reads_a_jax_exported_teacher(square_shards,
                                                       tmp_path, cfg_scale):
    """A FiT teacher written by JAX's torch_export (reference layout) is
    read by ``--teacher-ckpt``: the CLI's teacher velocity (guided with the
    null class when the scale is above 0) equals JAX's FiT on the same
    input within 1e-5 relative, and one distillation step runs."""
    tkw = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=32,
               depth=2, num_heads=2, num_classes=10, learn_sigma=False,
               max_cached_len=8, adaln_type='lora', adaln_lora_dim=8)
    jt = JFiT(**tkw)
    g, m, s = j_grid(BATCH, 4, 4, 16)
    tparams = randomize(jax.eval_shape(
        jt.init, jax.random.PRNGKey(0), jnp.zeros((BATCH, 16, 16)),
        jnp.zeros((BATCH,)), jnp.zeros((BATCH,), jnp.int32), g, m, s)[
            'params'], seed=8)
    path = str(tmp_path / 'teacher.safetensors')
    save_safetensors(export_fit_state_dict(
        jax.tree_util.tree_map(np.asarray, tparams), depth=2,
        adaln_type='lora', num_heads=2), path)
    tcfg = str(tmp_path / 'teacher.yaml')
    with open(tcfg, 'w') as f:
        yaml.safe_dump({'diffusion': {'network_config': {
            'target': 'fitv2_tpu.models.fit.FiT', 'params': tkw}}}, f)
    kw = {k: v for k, v in KW.items() if k != 'class_dropout_prob'}
    cfg = _write_config(tmp_path, 'fitv2_tpu.models.fit_lwd.FiTLwD', kw,
                        square_shards)
    argv = ['--cfgdir', cfg, '--distillation', '--teacher-ckpt', path,
            '--teacher-config', tcfg, '--teacher-cfg-scale', str(cfg_scale),
            '--device', 'cpu', '--output-dir', str(tmp_path / 'out'),
            '--max-steps', '1', '--no-resume']
    from fitv2_tpu_torch.utils.config import load_config
    args = cli.parse_args(argv)
    apply = cli.build_teacher_apply(args, load_config([cfg]), 'cpu')
    b = _batch(JFiTLwD(**KW), seed=5)
    x = np.random.default_rng(6).standard_normal((BATCH, 16, 16)).astype(
        np.float32)
    t = np.array([0.1, 0.4, 0.6, 0.9], np.float32)
    y = b['label']
    fwd = jax.jit(lambda p, *a: jt.apply({'params': p}, *a),
                  compiler_options=NO_OPT)
    if cfg_scale:
        dup = lambda a: np.concatenate([a, a])  # noqa: E731
        out = fwd(tparams, dup(x), dup(t), np.concatenate([y, y * 0 + 10]),
                  dup(b['grid']), dup(b['mask']), dup(b['size']))
        cond, uncond = np.split(np.asarray(out), 2)
        ref = uncond + cfg_scale * (cond - uncond)
    else:
        ref = np.asarray(fwd(tparams, x, t, y, b['grid'], b['mask'],
                             b['size']))
    with torch.no_grad():
        ours = apply(torch.from_numpy(x), torch.from_numpy(t),
                     {k: torch.from_numpy(v) for k, v in b.items()})
    assert _rel(ours, ref) <= 1e-5
    cli.main(argv)
    assert os.listdir(tmp_path / 'out' / 'checkpoints') == ['checkpoint-1']
