"""PyTorch port, data parallel (fitv2_tpu_torch.parallel and its users):
``MeshConfig.resolve`` against JAX's, then one spawn of two gloo CPU
processes (``torch.multiprocessing``; ``_worker`` below, each rank through
``parallel.init_distributed`` on torchrun's variables) whose results are
held against one process and against JAX:

  - each rank's share of a global loader batch: those rows of the
    one-process batch;
  - one FiT train step at global batch 8 (make_train_step): the ranks
    bit-identical; with the (seed, step) generator, the step's gradient
    (Adam's first moment) within 1e-6 relative L2 of one process's step on
    the whole batch; with explicit draws, within 1e-5 of JAX's
    single-process step (loss, gradient norm, gradient);
  - one LwDTrainer batch: the ranks bit-identical, the gradient within
    1e-6 of one process's;
  - ``process_allgather`` and the barrier;
  - Trainer checkpoints: process 0 writes them, every rank restores, and a
    run resumed across two trainers is bit-identical to an uninterrupted
    one;
  - the inline eval hook at step 2 of a Trainer (``one_process_model``,
    ``gathered_ema``): both ranks hold the same EMA, rank 0 alone writes
    the preview, which one process's hook on that EMA gives bit for bit;
  - a preemption signal on rank 1 stops both ranks after the same step
    (the next one that the agreement cadence divides),
    and ranks that initialise their own weights train from rank 0's;
  - cross-process moments equal the one-process ones, and
    ``check_cross_process_consistency`` is true and false;
  - FID generation (N 10, batch 2) and ``cli/sample --data-parallel``:
    rank r's batch b is one process's call with (seed, r, b), process 0's
    draws are the one-process loop's, and the CLI's npz is the ranks'
    images in rank order.
"""

import os
import signal
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fitv2_tpu_torch.data import make_synthetic_latent_shards
from fitv2_tpu_torch.data.latent_dataset import INLatentLoader
from fitv2_tpu_torch.flow import create_transport
from fitv2_tpu_torch.models import FiT, FiTLwD
from fitv2_tpu_torch.parallel import mesh as pmesh
from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
from fitv2_tpu_torch.sample.pipeline import (
    _batch_inputs, generate_fid_samples)
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.train.eval_hook import InlineEvalHook
from fitv2_tpu_torch.train.lwd_trainer import LwDTrainer, LwDTrainerConfig
from fitv2_tpu_torch.train.trainer import (
    Trainer, TrainerConfig, step_generator)
from fitv2_tpu_torch.utils import misc, training_stats

WORLD, GB, SEED, LR = 2, 8, 5, 1e-4
TINY = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
            depth=2, num_heads=4, learn_sigma=False, use_sit=True,
            use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
            adaln_type='lora', adaln_lora_dim=16, num_classes=10,
            max_cached_len=16)
LWD = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
           depth=4, num_heads=4, num_classes=10, number_of_perflow=2,
           n_patch_h=4, n_patch_w=4, adaln_type='lora', adaln_lora_dim=16,
           max_cached_len=8)
# the CLI's sampler for its flags below (bf16 model inputs)
SAMPLE = dict(image_height=32, image_width=32, num_sampling_steps=3,
              num_classes=10, per_device_batch=2)
HOOK = dict(SAMPLE, dtype=torch.float32)
N_FID = 10
DEADLINE_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _adam_mu(state) -> torch.Tensor:
    opt = state.optimizer
    return _flat(opt.state[p]['mu'] for p in state.params.values())


def _summary(state) -> dict:
    return dict(step=state.step, params=_flat(state.params.values()),
                ema=_flat(state.ema_params.values()), mu=_adam_mu(state))


def _loader(root, backend='python'):
    return INLatentLoader(root, target_len=16, batch_size=GB, num_workers=1,
                          backend=backend)


def _first_batch(root, rank=0, world=1):
    it = _loader(root).train_dataloader(GB, 1, 0, SEED, process_index=rank,
                                        process_count=world)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in next(iter(it))
            .items()}


def _fit(init):
    model = FiT(**TINY)
    model.load_state_dict(init)
    return model


def one_step(init, batch, generator=None, draws=None):
    """One make_train_step update of the FiT from ``init`` on ``batch``
    (fp32 masters, fp32 moments, EMA 0.9, as the JAX reference's)."""
    model = _fit(init)
    state = tts.create_train_state(model, tts.OptimizerConfig(
        learning_rate=LR))
    step = tts.make_train_step(model, create_transport(), ema_decay=0.9)
    _, metrics = step(state, batch, generator=generator, draws=draws)
    return dict(_summary(state), loss=float(metrics['loss']),
                grad_norm=float(metrics['grad_norm']))


def _trainer(root, out, seed=0, **kw):
    torch.manual_seed(seed)
    cfg = dict(data_path=root, target_len=16, global_batch_size=GB,
               num_workers=1, loader_backend='python', max_steps=4,
               learning_rate=LR, lr_warmup_steps=0, mixed_precision='no',
               mu_dtype=None, seed=SEED, device='cpu', output_dir=out,
               checkpointing_steps=100, log_every=1)
    cfg.update(kw)
    return Trainer(FiT(**TINY), TrainerConfig(**cfg))


def lwd_run(root, out):
    """One LwDTrainer batch (one segment update) from a seeded FiTLwD."""
    torch.manual_seed(1)
    tr = LwDTrainer(FiTLwD(**LWD), LwDTrainerConfig(
        data_path=root, target_len=16, global_batch_size=GB, num_workers=1,
        max_steps=1, segments_per_step=1, seed=SEED, output_dir=out,
        device='cpu'), loader=_loader(root))
    return _summary(tr.train(resume=False))


def fid_sampler(init):
    return build_sampler(_fit(init).eval(), SamplingConfig(**SAMPLE))


# -- the two ranks ------------------------------------------------------------

def _worker(rank, port, root, inputs):
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)
    assert pmesh.init_distributed('cpu') == (rank, WORLD)
    assert dist.get_backend() == 'gloo'
    out = {'batch': _first_batch(inputs['shards'], rank, WORLD)}
    rows = slice(rank * GB // WORLD, (rank + 1) * GB // WORLD)
    out['step_gen'] = one_step(inputs['init'], out['batch'],
                               generator=step_generator(SEED, 0))
    out['step_draws'] = one_step(
        inputs['init'], out['batch'],
        draws={k: torch.from_numpy(v[rows]) for k, v in
               inputs['draws'].items()})
    out['steps_consistent'] = [misc.check_cross_process_consistency(
        out[k]['params'], k) for k in ('step_gen', 'step_draws')]
    out['lwd'] = lwd_run(inputs['lwd_shards'], os.path.join(root, 'lwd'))
    out['lwd_consistent'] = misc.check_cross_process_consistency(
        out['lwd']['params'], 'lwd')

    out['gather'] = pmesh.process_allgather(np.full((3,), rank, np.int64))
    out['gather_tiled'] = pmesh.process_allgather(
        torch.full((2, 2), float(rank)), tiled=True)
    if rank == 1:
        time.sleep(0.5)
    out['barrier_in'] = time.time()
    pmesh.sync_global_devices('test')
    out['barrier_out'] = time.time()

    shards = inputs['shards']
    whole = _trainer(shards, os.path.join(root, 'whole'))
    out['whole'] = _summary(whole.train(resume=False))
    part = os.path.join(root, 'part')
    _trainer(shards, part, checkpointing_steps=2).train(max_steps=2,
                                                        resume=False)
    out['saved'] = sorted(os.listdir(os.path.join(part, 'checkpoints')))
    resumed = _trainer(shards, part)
    out['resumed'] = _summary(resumed.train(resume=True))
    out['resumed_consistent'] = misc.check_cross_process_consistency(
        out['resumed']['params'], 'resumed')

    # the inline eval hook at step 2: each rank samples, rank 0 writes
    hooked = _trainer(shards, os.path.join(root, 'hooked'), max_steps=2)
    hook = InlineEvalHook(
        hooked.one_process_model, SamplingConfig(**HOOK), every=2, seed=3,
        device='cpu', out_dir=os.path.join(root, 'preview', f'rank{rank}'))
    hook.attach(hooked.gathered_ema)
    out['hook_ema'] = dict(hooked.train(resume=False,
                                        metric_hook=hook).ema_params)

    def hook(step, metrics):
        if rank == 1 and step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    # each rank initialises its own weights: the run starts from rank 0's
    pre = _trainer(shards, os.path.join(root, 'preempt'), seed=rank,
                   max_steps=50, preemption_sync_every=3)
    state = pre.train(resume=False, metric_hook=hook)
    out['preempt'] = dict(step=state.step, preempted=pre.preempted,
                          saved=sorted(os.listdir(os.path.join(
                              root, 'preempt', 'checkpoints'))))
    out['preempt_consistent'] = misc.check_cross_process_consistency(
        _flat([*state.params.values(), *state.ema_params.values()]))

    values = inputs['stats'][rank]
    coll = training_stats.Collector(regex='loss')
    training_stats.report('loss', values)
    training_stats.report0('rank0_only', 1.0)
    out['report0'] = 'rank0_only' in training_stats._counters
    coll.update(cross_process=True)  # the same names on every rank
    out['stats'] = coll.as_dict()['loss']
    out['psum'] = training_stats.psum_moments(torch.from_numpy(values))
    out['consistent_same'] = misc.check_cross_process_consistency(
        torch.arange(4.0))
    out['consistent_differs'] = misc.check_cross_process_consistency(
        torch.tensor([float(rank)]))

    fn = fid_sampler(inputs['init'])
    out['fid'] = generate_fid_samples(
        fn, N_FID, 2, num_classes=10, seed=SEED,
        resume_dir=os.path.join(root, 'fid_resume'))
    from fitv2_tpu_torch.cli import sample as cli
    cli.main(['--cfgdir', inputs['cfg'], '--ckpt', inputs['ckpt'],
              '--image-height', '32', '--image-width', '32',
              '--num-sampling-steps', '3', '--num-fid-samples', str(N_FID),
              '--per-device-batch', '2', '--num-classes', '10',
              '--global-seed', str(SEED), '--device', 'cpu',
              '--data-parallel', '--out', os.path.join(root, 'dp.npz')])
    torch.save(out, os.path.join(root, f'rank{rank}.pt'))
    dist.destroy_process_group()


def _spawn(root, inputs):
    ctx = mp.spawn(_worker, args=(_free_port(), root, inputs),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f'the {WORLD} ranks did not finish in {DEADLINE_S} s')


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    """Inputs, the two ranks' results and the one-process references."""
    import yaml
    from fitv2_tpu.ckpt.torch_export import (
        export_fit_state_dict, save_safetensors)
    from test_torch_port_int8_lwd import jax_tree
    from fitv2_tpu_torch.ckpt import state_dict_from_jax

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp('dp'))
    shards, lwd_shards = (os.path.join(root, d) for d in ('fit', 'lwd_data'))
    make_synthetic_latent_shards(shards, n=32, target_len=16, n_classes=10,
                                 seed=1)
    make_synthetic_latent_shards(lwd_shards, n=32, target_len=16,
                                 n_classes=10, seed=2, square=True)
    params = jax_tree(FiT(**TINY), seed=3)
    params_np = {'params': __import__('jax').tree_util.tree_map(
        np.asarray, params)}
    init = state_dict_from_jax(params_np, depth=2, num_heads=4,
                               adaln_type='lora')
    rng = np.random.default_rng(4)
    draws = dict(t=rng.uniform(0.05, 0.95, GB).astype(np.float32),
                 x0=rng.standard_normal((GB, 16, 16)).astype(np.float32),
                 drop_ids=np.array([0, 1, 0, 0, 1, 0, 0, 0], np.int32))
    cfg = os.path.join(root, 'tiny.yaml')
    with open(cfg, 'w') as f:
        yaml.safe_dump({'diffusion': {'network_config': {
            'target': 'fitv2_tpu.models.fit.FiT', 'params': TINY}}}, f)
    ckpt = os.path.join(root, 'tiny.safetensors')
    save_safetensors(export_fit_state_dict(
        params_np['params'], depth=2, adaln_type='lora', num_heads=4,
        rope_layout='split'), ckpt)
    stats = [np.random.default_rng(10 + r).standard_normal(5 + r)
             .astype(np.float32) for r in range(WORLD)]
    inputs = dict(shards=shards, lwd_shards=lwd_shards, init=init,
                  draws=draws, cfg=cfg, ckpt=ckpt, stats=stats)
    _spawn(root, inputs)
    ranks = [torch.load(os.path.join(root, f'rank{r}.pt'),
                        weights_only=False) for r in range(WORLD)]
    yield dict(root=root, inputs=inputs, ranks=ranks, params=params)
    torch.set_num_threads(prev)


def rel_l2(a, b):
    a, b = (torch.as_tensor(np.asarray(v), dtype=torch.float64)
            for v in (a, b))
    return float((a - b).norm() / b.norm())


# -- the mesh ----------------------------------------------------------------

RESOLVE_CASES = [({}, 1), ({}, 8), (dict(data=2), 2), (dict(data=4), 8),
                 (dict(data=-1, fsdp=2), 8), (dict(data=2, tensor=-1), 8),
                 (dict(stage=2, fsdp=2, sequence=2), 8),
                 (dict(data=1, tensor=4), 4), (dict(data=3), 8),
                 (dict(data=-1, fsdp=-1), 8), (dict(data=-1, fsdp=3), 8)]


@pytest.mark.parametrize('kw,n', RESOLVE_CASES)
def test_mesh_resolve_matches_jax(kw, n):
    from fitv2_tpu.parallel.mesh import MeshConfig as JMeshConfig
    try:
        want = JMeshConfig(**kw).resolve(n)
    except AssertionError:
        with pytest.raises(AssertionError):
            pmesh.MeshConfig(**kw).resolve(n)
        return
    assert pmesh.MeshConfig(**kw).resolve(n) == want


@pytest.mark.parametrize('backend,want', [('nccl', 'cuda'), ('gloo', 'cpu'),
                                          (None, 'cpu')])
def test_build_mesh_lays_the_process_groups_device(monkeypatch, backend,
                                                   want):
    """Without a device_type, the DeviceMesh is of the process group's
    device: the card under NCCL, the host under gloo or with no group."""
    import torch.distributed.device_mesh as device_mesh
    laid = []
    monkeypatch.setattr(pmesh, '_active', lambda: backend is not None)
    monkeypatch.setattr(pmesh.dist, 'get_backend', lambda: backend)
    monkeypatch.setattr(pmesh, 'process_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(device_mesh, 'init_device_mesh',
                        lambda kind, sizes, **kw: laid.append(kind))
    mesh = pmesh.build_mesh(pmesh.MeshConfig(data=1, tensor=2))
    assert laid == [want] and mesh.shape['tensor'] == 2
    assert pmesh.collective_device().type == want
    pmesh.build_mesh(pmesh.MeshConfig(data=1, tensor=2), device_type='cpu')
    assert laid == [want, 'cpu']  # a caller's choice stands


def test_build_mesh_takes_the_data_axis_only():
    # every axis is ported: the sizes resolve as JAX's (the sharded runs
    # are test_torch_port_sharding.py's)
    assert pmesh.build_mesh().shape == dict(data=1, stage=1, fsdp=1,
                                            sequence=1, tensor=1)
    assert pmesh.build_mesh(pmesh.MeshConfig(data=4), 4).shape['data'] == 4
    for axis in ('stage', 'fsdp', 'sequence', 'tensor'):
        mesh = pmesh.build_mesh(pmesh.MeshConfig(data=1, **{axis: 2}), 2)
        assert mesh.shape[axis] == 2 and mesh.shards_model
        assert mesh.device_mesh is None  # one process: no process groups
    with pytest.raises(AssertionError):
        pmesh.build_mesh(pmesh.MeshConfig(data=2))  # one process
    # one process: every helper acts on it alone
    assert pmesh.init_distributed('cpu') == (0, 1)
    assert np.array_equal(pmesh.process_allgather(np.arange(3)),
                          np.arange(3)[None])
    assert pmesh.is_main_process()
    with pmesh.row_shard_draws(torch.Generator()):
        assert torch.rand(3).shape == (3,)


# -- the two ranks against one process and JAX -------------------------------

def test_each_rank_loads_its_rows_of_the_global_batch(dp):
    whole = _first_batch(dp['inputs']['shards'])
    assert (whole['mask'].sum(1) < 16).any()  # padded, non-square grids
    for r, res in enumerate(dp['ranks']):
        for k, v in res['batch'].items():
            assert torch.equal(v, whole[k][r * 4:(r + 1) * 4]), k


def test_train_step_equals_one_process_on_the_whole_batch(dp):
    a, b = (res['step_gen'] for res in dp['ranks'])
    assert all(res['steps_consistent'] == [True, True]
               for res in dp['ranks'])
    for k in ('params', 'ema', 'mu'):
        assert torch.equal(a[k], b[k]), k
    ref = one_step(dp['inputs']['init'], _first_batch(dp['inputs']['shards']),
                   generator=step_generator(SEED, 0))
    assert rel_l2(a['mu'], ref['mu']) <= 1e-6
    np.testing.assert_allclose(a['loss'], ref['loss'], rtol=1e-6)
    np.testing.assert_allclose(a['grad_norm'], ref['grad_norm'], rtol=1e-6)
    # a step of Adam moves each parameter by about lr
    assert (a['params'] - ref['params']).abs().max() <= 2 * LR


def test_train_step_matches_jax_single_process(dp):
    import jax.numpy as jnp
    from test_torch_port_train import _jax_steps
    a, b = (res['step_draws'] for res in dp['ranks'])
    assert torch.equal(a['params'], b['params'])
    batch = {k: v.numpy() for k, v in
             _first_batch(dp['inputs']['shards']).items()}
    _, jstate, jmetrics, jgrads = _jax_steps(
        dp['params'], batch, dp['inputs']['draws'], jnp.float32, LR, steps=1)
    np.testing.assert_allclose(a['loss'], float(jmetrics[0]['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(a['grad_norm'],
                               float(jmetrics[0]['grad_norm']), rtol=1e-5)
    from fitv2_tpu_torch.ckpt import state_dict_from_jax
    jg = state_dict_from_jax(jgrads, depth=2, num_heads=4, adaln_type='lora')
    names = [n for n, _ in FiT(**TINY).named_parameters()]
    clip = min(1.0, 1.0 / a['grad_norm'])  # make_step clips to norm 1
    want = _flat(jg[n] for n in names) * clip
    assert rel_l2(a['mu'] / 0.1, want) <= 1e-5


def test_lwd_trainer_batch_equals_one_process(dp):
    a, b = (res['lwd'] for res in dp['ranks'])
    assert all(res['lwd_consistent'] for res in dp['ranks'])
    assert torch.equal(a['params'], b['params']) and a['step'] == 1
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        ref = lwd_run(dp['inputs']['lwd_shards'], out)
    assert rel_l2(a['mu'], ref['mu']) <= 1e-6


def test_allgather_and_barrier(dp):
    for res in dp['ranks']:
        assert np.array_equal(res['gather'], [[0, 0, 0], [1, 1, 1]])
        assert torch.equal(res['gather_tiled'], torch.tensor(
            [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]))
    # neither rank leaves the barrier before the other has reached it
    r0, r1 = dp['ranks']
    assert r0['barrier_out'] >= r1['barrier_in']
    assert r1['barrier_out'] >= r0['barrier_in']


def test_rank0_saves_every_rank_restores_and_resume_is_exact(dp):
    r0, r1 = dp['ranks']
    assert r0['saved'] == r1['saved'] == ['checkpoint-2']
    for res in dp['ranks']:
        assert res['resumed_consistent']
        assert res['whole']['step'] == res['resumed']['step'] == 4
        for k in ('params', 'ema', 'mu'):
            assert torch.equal(res['whole'][k], res['resumed'][k]), k
    assert torch.equal(r0['resumed']['params'], r1['resumed']['params'])
    ckpts = os.listdir(os.path.join(dp['root'], 'part', 'checkpoints'))
    assert sorted(ckpts) == ['checkpoint-2', 'checkpoint-4']  # no leftovers


def test_preemption_on_one_rank_stops_both_after_the_same_step(dp):
    for res in dp['ranks']:
        # the signal at step 2, agreed at the next multiple of 3
        assert res['preempt'] == dict(step=3, preempted=True,
                                      saved=['checkpoint-3'])
        assert res['preempt_consistent']  # rank 0's initial weights


def test_cross_process_stats_and_consistency(dp):
    values = np.concatenate(dp['inputs']['stats'])
    want = training_stats.Collector(regex='loss')
    training_stats.report('loss', values)
    want.update()
    assert [res['report0'] for res in dp['ranks']] == [True, False]
    for res in dp['ranks']:
        np.testing.assert_allclose(
            [res['stats'][k] for k in ('num', 'mean', 'std')],
            [want.num('loss'), want.mean('loss'), want.std('loss')],
            rtol=1e-6)
        np.testing.assert_allclose(
            res['psum'], training_stats.moments(torch.from_numpy(values)),
            rtol=1e-6)
        assert res['consistent_same'] and not res['consistent_differs']


def test_inline_eval_hook_writes_on_process_0_only(dp, tmp_path):
    """Data parallel, both ranks run the hook at step 2 on the same EMA;
    only rank 0 writes the preview, which equals one process's hook on
    that EMA bit for bit."""
    r0, r1 = dp['ranks']
    for n, t in r0['hook_ema'].items():
        assert torch.equal(t, r1['hook_ema'][n]), n
    hook = InlineEvalHook(FiT(**TINY), SamplingConfig(**HOOK), every=2,
                          seed=3, out_dir=str(tmp_path))
    hook.attach(lambda: r0['hook_ema'])
    hook(2, {})
    preview = os.path.join(dp['root'], 'preview')
    assert sorted(os.listdir(preview)) == ['rank0']
    np.testing.assert_array_equal(
        np.load(os.path.join(preview, 'rank0', 'preview_2.npz'))['arr_0'],
        np.load(tmp_path / 'preview_2.npz')['arr_0'])


def test_fid_generation_per_rank_and_the_cli(dp):
    fn = fid_sampler(dp['inputs']['init'])
    per = int(np.ceil(N_FID / WORLD))
    for r, res in enumerate(dp['ranks']):
        assert res['fid'].shape == (per, 4, 4, 4)
        for b in range(int(np.ceil(per / 2))):
            labels, gen = _batch_inputs(SEED, b, 2, 10, rank=r)
            want = fn(labels, generator=gen).numpy()
            got = res['fid'][2 * b:2 * b + 2]
            assert np.array_equal(got, want[:len(got)]), (r, b)
    # rank 0's draws are the one-process loop's: SeedSequence([seed, b])
    ss = np.random.SeedSequence([SEED, 1]).generate_state(2, np.uint64)
    labels, gen = _batch_inputs(SEED, 1, 2, 10)
    assert np.array_equal(labels.numpy(), np.random.default_rng(
        ss[0]).integers(0, 10, size=2))
    assert torch.equal(torch.randn(3, generator=gen), torch.randn(
        3, generator=torch.Generator().manual_seed(int(ss[1]))))
    one = generate_fid_samples(fn, 4, 2, num_classes=10, seed=SEED)
    assert np.array_equal(one, dp['ranks'][0]['fid'][:4])
    resume = sorted(os.listdir(os.path.join(dp['root'], 'fid_resume')))
    assert resume == ['manifest.json'] + [
        f'shard_p{r}_b{b}.npy' for r in range(WORLD) for b in range(3)]
    npz = np.load(os.path.join(dp['root'], 'dp.npz'))['arr_0']
    assert np.array_equal(npz, np.concatenate(
        [res['fid'] for res in dp['ranks']])[:N_FID])
