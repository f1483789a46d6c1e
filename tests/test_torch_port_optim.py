"""PyTorch port, slice 5c: CAME, the grouped and finetune optimizers,
``bfm.split_decay_param_labels``, the JAX-leaf map they rest on, and the
inline eval hook, against the JAX package on the same numpy inputs.

Models: a FiTv2 of depth 2 (hidden 64, 4 heads; its blocks scanned, as
JAX's default, and unscanned), the LwD tests' FiTLwD (K 2 segments of 2
blocks, REPA blocks, per-segment embedders, a shared trunk, the Fourier
basis) and a shared-encoder BFM at the same widths, every parameter
randomised on the JAX side and carried over by the converters. Gradients
are seeded numpy draws of each parameter's shape.

Tolerances:
- CAME, five steps with an lr schedule: each parameter's move and each
  state tensor within 2e-5 of its largest magnitude (fp32 means, rsqrt and
  the RMS in other orders); a resume is bit-identical;
- the grouped / finetune optimizers (AdamW, CAME inside a group): each
  parameter's move within 1e-5 of its largest magnitude for AdamW (Adam's
  update is within 1e-7 of JAX's, but a parameter's own rounding, p + u
  landing one ulp of p apart, is ~4e-6 of a three-step move), 2e-5 for
  CAME; frozen parameters keep their bits;
- the labels: equal for every parameter;
- the hook's preview (latents, two Euler steps): 5e-5, the sampler
  tests' tolerance.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.models import bfm as jbfm
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.fit_lwd_sharedenc import (
    FiTLwDSharedEncSepDec as JShared)
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.sample.pipeline import SamplingConfig as JSamplingConfig
from fitv2_tpu.train import came as jcame
from fitv2_tpu.train import train_step as jts
from fitv2_tpu.train.eval_hook import InlineEvalHook as JInlineEvalHook

from fitv2_tpu_torch.ckpt import (
    came_state_from_jax, jax_leaves, lwd_state_from_jax, state_dict_from_jax,
    train_state_from_jax)
from fitv2_tpu_torch.models import FiT, FiTLwD, FiTLwDSharedEncSepDec
from fitv2_tpu_torch.models.bfm import split_decay_param_labels
from fitv2_tpu_torch.sample.pipeline import SamplingConfig
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.train.came import CAME
from fitv2_tpu_torch.train.eval_hook import InlineEvalHook

FIT = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
           depth=2, num_heads=4, learn_sigma=False, use_sit=True,
           use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
           adaln_type='lora', adaln_lora_dim=16, num_classes=10,
           max_cached_len=16)
LWD = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
           depth=4, num_heads=4, num_classes=10, number_of_perflow=2,
           n_patch_h=4, n_patch_w=4, adaln_type='lora', adaln_lora_dim=16,
           max_cached_len=8, number_of_representation_blocks=2, repa_dim=24,
           perlayer_embedder=True, number_of_shared_blocks=1,
           fourier_basis=True)
BFM = dict(LWD, depth=2, number_of_representation_blocks=1, repa_dim=16,
           perlayer_embedder=False, number_of_shared_blocks=0,
           fourier_basis=False, q_norm='rmsnorm', k_norm='rmsnorm')
FAMILIES = {'fit': (JFiT, FiT, FIT), 'fit_unscanned': (
    JFiT, FiT, dict(FIT, scan_blocks=False)), 'lwd': (JFiTLwD, FiTLwD, LWD),
    'bfm': (JShared, FiTLwDSharedEncSepDec, BFM)}
TOL_CAME = 2e-5
TOL_ADAM = 1e-5
NO_OPT = {'xla_backend_optimization_level': 0}  # halves the compiles


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


_MODELS = {}


def family(name):
    """(JAX model, randomised numpy params, the port's model on them, the
    converter of a params-shaped JAX tree to the port's names), once a
    process."""
    if name not in _MODELS:
        jcls, pcls, kw = FAMILIES[name]
        jm, pm = jcls(**kw), pcls(**kw)
        g, m, s = j_grid(2, 4, 4, 16)
        shapes = jax.eval_shape(
            jm.init, {'params': jax.random.PRNGKey(0),
                      'label_dropout': jax.random.PRNGKey(1)},
            jnp.zeros((2, 16, 16)), jnp.zeros((2,)), jnp.zeros((2,), jnp.int32),
            g, m, s)['params']
        rng = np.random.default_rng(len(_MODELS))
        params = jax.tree_util.tree_map(lambda v: (0.05 * rng.standard_normal(
            v.shape)).astype(np.float32), shapes)
        if pcls is FiT:
            def convert(tree):
                return state_dict_from_jax(tree, depth=kw['depth'],
                                           num_heads=4, adaln_type='lora')
        else:
            def convert(tree):
                return lwd_state_from_jax(tree, pm)
        pm.load_state_dict(convert(params), strict=True)
        _MODELS[name] = (jm, params, pm, convert)
    return _MODELS[name]


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda v: rng.standard_normal(v.shape).astype(np.float32)
        * rng.uniform(0.1, 2.0), params)


def _set_grads(masters, grads_sd):
    for name, p in masters.items():
        p.grad = grads_sd[name].clone()


def _schedule(count):
    return 1e-3 * (count + 1) / 5  # a warm-up: each step's lr differs


@pytest.mark.parametrize('name', list(FAMILIES))
def test_jax_leaves_cover_the_jax_tree(name):
    """Every JAX leaf, its path and shape, from the port's parameters: the
    axes CAME factors and the rank the decay labels read."""
    from fitv2_tpu_torch.ckpt.convert import _flatten
    _, params, pm, _ = family(name)
    want = {k: v.shape for k, v in _flatten(params).items()}
    sd = dict(pm.named_parameters())
    got = {}
    for leaf in jax_leaves(pm):
        shape = tuple(sd[leaf.names[0]].shape)
        shape = shape[::-1] if leaf.transpose else shape
        got[leaf.path] = (len(leaf.names),) + shape if leaf.stacked \
            else shape
        assert len(got[leaf.path]) == leaf.ndim
    assert got == want
    assert sum(len(leaf.names) for leaf in jax_leaves(pm)) == len(sd)


_JAX_CAME = {}


def _jax_came_update(name):
    """JAX's ``came(_schedule, weight_decay=wd)`` update over a family's
    tree, jitted once a family with wd traced: ``came(weight_decay=1.0)``
    given wd * params, whose decay stage adds wd * p (0 at wd 0, where
    ``came`` leaves the stage out and adds nothing)."""
    if name not in _JAX_CAME:
        tx = jcame.came(_schedule, weight_decay=1.0)

        def update(grads, state, params, wd):
            return tx.update(grads, state, jax.tree_util.tree_map(
                lambda p: wd * p, params))
        _JAX_CAME[name] = tx, jax.jit(update, compiler_options=NO_OPT)
    return _JAX_CAME[name]


def _came_run(name, wd, steps=5):
    jm, params, pm, convert = family(name)
    jtx, update = _jax_came_update(name)
    jstate = jtx.init(params)
    jparams = params
    model = copy.deepcopy(pm)
    masters = dict(model.named_parameters())
    opt = CAME(masters, jax_leaves(model), lr=_schedule, weight_decay=wd)
    for step in range(steps):
        grads = _grads(params, step)
        upd, jstate = update(grads, jstate, jparams, np.float32(wd))
        jparams = optax.apply_updates(jparams, upd)
        _set_grads(masters, convert(grads))
        opt.step()
    return (model, masters, opt, jax.device_get(jparams),
            jax.device_get(jstate))


@pytest.mark.parametrize('name,wd', [
    ('fit', 0.0), ('fit', 0.1), ('fit_unscanned', 0.1), ('lwd', 0.0),
    ('lwd', 0.1), ('bfm', 0.1)])
def test_came_matches_jax(name, wd):
    _, params, pm, convert = family(name)
    model, masters, opt, jparams, jstate = _came_run(name, wd)
    start, want = convert(params), convert(jparams)
    for n, p in masters.items():
        assert _rel(p.detach() - start[n], want[n] - start[n]) <= TOL_CAME, n
    # the state, leaf by leaf in JAX's layout (came_state_from_jax reads
    # JAX's tree into a fresh optimizer)
    fresh = CAME(masters, jax_leaves(model), lr=_schedule)
    came_state_from_jax(jstate, model, fresh)
    for leaf in opt.leaves:
        first = opt.leaf_params(leaf)[0]
        mine, theirs = opt.state[first], fresh.state[first]
        assert sorted(mine) == sorted(theirs)
        for k, v in theirs.items():
            assert mine[k].shape == v.shape
            assert _rel(mine[k], v) <= TOL_CAME, k


def test_came_resume_is_bit_identical():
    """Five updates against three, a state_dict round trip into a new
    model and optimizer, then two more: the scanned FiT (stacked and
    unstacked, factored and unfactored leaves)."""
    _, params, pm, convert = family('fit')
    runs = []
    for resume in (False, True):
        model = copy.deepcopy(pm)
        masters = dict(model.named_parameters())
        opt = CAME(masters, jax_leaves(model), lr=_schedule,
                   weight_decay=0.1)
        for step in range(5):
            if resume and step == 3:
                saved = copy.deepcopy((opt.state_dict(), model.state_dict()))
                model = copy.deepcopy(pm)
                model.load_state_dict(saved[1])
                masters = dict(model.named_parameters())
                opt = CAME(masters, jax_leaves(model), lr=_schedule,
                           weight_decay=0.1)
                opt.load_state_dict(saved[0])
            _set_grads(masters, convert(_grads(params, step)))
            opt.step()
        runs.append((model.state_dict(), opt.state_dict()))
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k
    for i, st in runs[0][1]['state'].items():
        for k, v in st.items():
            assert torch.equal(v, runs[1][1]['state'][i][k]), (i, k)
    assert runs[0][1]['param_groups'][0]['count'] == 5


def test_train_state_from_jax_carries_came():
    """A JAX TrainState under make_optimizer(optimizer='came') with a
    schedule: the masters, the CAME state and the count."""
    jm, params, pm, convert = family('fit')
    cfg = jts.OptimizerConfig(optimizer='came', lr_schedule=_schedule)
    tx = jts.make_optimizer(cfg)
    state = jts.create_train_state(params, tx)
    upd, opt_state = jax.jit(tx.update, compiler_options=NO_OPT)(
        _grads(params, 0), state.opt_state, params)
    state = state.replace(step=1, params=optax.apply_updates(params, upd),
                          opt_state=opt_state)
    port = train_state_from_jax(jax.device_get(state), copy.deepcopy(pm),
                                tts.OptimizerConfig(optimizer='came',
                                                    lr_schedule=_schedule))
    assert isinstance(port.optimizer, CAME)
    assert port.optimizer.param_groups[0]['count'] == 1 and port.step == 1
    want = convert(jax.device_get(state.params))
    for n, p in port.params.items():
        assert torch.equal(p, want[n]), n
    assert all(port.optimizer.state[port.optimizer.leaf_params(leaf)[0]]
               for leaf in port.optimizer.leaves)


def _clip_grads(params, step, scale):
    """Gradients whose trained group's norm is well above the clip."""
    return jax.tree_util.tree_map(lambda g: g * scale,
                                  _grads(params, step))


def test_finetune_optimizer_matches_jax():
    """Only 'adaLN' and 'norm' parameters train, clipped by their own
    group's norm (JAX's clip sits inside the multi_transform group);
    every other parameter keeps its bits and holds no state. The scanned
    FiT, whose finetune JAX's mirrors (its stacked adaLN leaves train)."""
    jm, params, pm, convert = family('fit')
    cfg = dict(learning_rate=1e-3, max_grad_norm=0.5, weight_decay=0.05)
    unfreeze = ('adaLN', 'norm')
    jtx = jts.make_finetune_optimizer(
        jts.make_optimizer(jts.OptimizerConfig(**cfg)), unfreeze)
    jstate = jtx.init(params)
    jparams = params
    update = jax.jit(jtx.update, compiler_options=NO_OPT)
    model = copy.deepcopy(pm)
    masters = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in masters.items()}
    opt = tts.make_finetune_optimizer(masters, tts.OptimizerConfig(**cfg),
                                      unfreeze, model=model)
    assert isinstance(opt, tts.MultiTransform)
    trained = {n for n, lab in opt.labels.items() if lab == 'train'}
    assert trained and len(trained) < len(masters)
    assert trained == {n for n in masters if 'adaLN' in n or 'norm' in n}
    for step in range(3):
        grads = _clip_grads(params, step, 10.0)
        upd, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        sd = convert(grads)
        train_norm = float(torch.stack([
            sd[n].double().square().sum() for n in trained]).sum().sqrt())
        assert train_norm > 10 * cfg['max_grad_norm']
        _set_grads(masters, sd)
        opt.step()
    want = convert(jax.device_get(jparams))
    for n, p in masters.items():
        if n in trained:
            assert _rel(p.detach() - start[n], want[n] - start[n]) \
                <= TOL_ADAM, n
        else:
            assert torch.equal(p.detach(), start[n]), n
    frozen_opt = opt.optimizers['frozen']
    assert frozen_opt is None
    assert set(opt.state_dict()) == {'train'}
    assert len(opt.optimizers['train'].state) == len(trained)


def test_split_decay_labels_equal_jax():
    """Each parameter's label is JAX's label of its leaf: keyword or rank
    <= 1 of the JAX leaf (a stacked bias is rank 2, a norm weight reads
    'norm' in its path on both sides)."""
    from fitv2_tpu_torch.ckpt.convert import _flatten
    for name in ('fit', 'lwd', 'bfm'):
        _, params, pm, _ = family(name)
        jlabels = {k: str(v) for k, v in _flatten(jax.tree_util.tree_map(
            np.asarray, jbfm.split_decay_param_labels(params))).items()}
        labels = split_decay_param_labels(pm)
        assert set(labels) == {n for n, _ in pm.named_parameters()}
        for leaf in jax_leaves(pm):
            for n in leaf.names:
                assert labels[n] == jlabels[leaf.path], (n, leaf.path)
        assert {'decay', 'no_decay'} == set(labels.values())
    labels = split_decay_param_labels(family('bfm')[2])
    assert labels['segments.0.0.attn.q_norm.weight'] == 'no_decay'


def test_grouped_optimizer_matches_jax():
    """BFM's decay grouping: CAME with decay on 'decay', AdamW without on
    'no_decay', each under its own clip."""
    jm, params, pm, convert = family('bfm')
    c_came = dict(optimizer='came', learning_rate=1e-3, weight_decay=0.1,
                  max_grad_norm=1.0)
    c_adam = dict(learning_rate=2e-3, max_grad_norm=0.5)
    jtx = optax.multi_transform(
        {'decay': jts.make_optimizer(jts.OptimizerConfig(**c_came)),
         'no_decay': jts.make_optimizer(jts.OptimizerConfig(**c_adam))},
        jbfm.split_decay_param_labels(params))
    jstate = jtx.init(params)
    jparams = params
    update = jax.jit(jtx.update, compiler_options=NO_OPT)
    model = copy.deepcopy(pm)
    masters = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in masters.items()}
    labels = split_decay_param_labels(model)
    opt = tts.make_grouped_optimizer(
        masters, lambda n, p: labels[n],
        {'decay': tts.OptimizerConfig(**c_came),
         'no_decay': tts.OptimizerConfig(**c_adam)}, model=model)
    assert isinstance(opt.optimizers['decay'], CAME)
    for step in range(3):
        grads = _clip_grads(params, step, 5.0)
        upd, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _set_grads(masters, convert(grads))
        opt.step()
    want = convert(jax.device_get(jparams))
    for n, p in masters.items():
        tol = TOL_CAME if labels[n] == 'decay' else TOL_ADAM
        assert _rel(p.detach() - start[n], want[n] - start[n]) <= tol, n


def test_train_step_with_a_finetune_optimizer():
    """make_step over a MultiTransform: the frozen masters keep their bits,
    the EMA moves every parameter as in JAX, the metric's norm is over
    every gradient."""
    torch.manual_seed(0)
    model = FiT(**FIT)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    cfg = tts.OptimizerConfig(learning_rate=1e-3)
    state = tts.create_train_state(model, cfg, optimizer_fn=lambda m: (
        tts.make_finetune_optimizer(m, cfg, ('adaLN',), model=model)))
    before = {n: p.detach().clone() for n, p in state.params.items()}
    from fitv2_tpu_torch.flow import create_transport
    step = tts.make_train_step(model, create_transport())
    rng = np.random.default_rng(0)
    batch = dict(feature=torch.from_numpy(rng.standard_normal(
        (2, 16, 16)).astype(np.float32)),
        grid=torch.from_numpy(np.stack([np.indices((4, 4)).reshape(2, 16)]
                                       * 2).astype(np.int64)),
        mask=torch.ones(2, 16), label=torch.tensor([1, 2]),
        size=torch.tensor([[[4, 4]]] * 2))
    _, metrics = step(state, batch, torch.Generator().manual_seed(0))
    moved = {n for n, p in state.params.items()
             if not torch.equal(p, before[n])}
    assert moved == {n for n in before if 'adaLN' in n}
    assert float(metrics['grad_norm']) > 0
    sd = state.state_dict()
    state.load_state_dict(sd)


def test_inline_eval_hook_preview_equals_jax(tmp_path):
    """The JAX hook and the port's on the same weights and JAX's draws of
    the step (labels and z from fold_in(PRNGKey(seed), step)): the same
    preview latents; off-cadence steps do nothing."""
    kw = dict(FIT, context_size=64, max_cached_len=32)
    jm = JFiT(**kw)
    g, m, s = j_grid(1, 8, 8, 64)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 16)), jnp.zeros((1,)),
                            jnp.zeros((1,), jnp.int32), g, m, s)['params']
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(lambda v: (0.1 * rng.standard_normal(
        v.shape)).astype(np.float32), shapes)
    common = dict(image_height=128, image_width=128, num_sampling_steps=2,
                  per_device_batch=2, num_classes=10)
    jhook = JInlineEvalHook(jm, JSamplingConfig(**common, dtype=jnp.float32),
                            every=5, out_dir=str(tmp_path / 'jax'), seed=3
                            ).attach(lambda: params)
    jhook(5, {})
    want = np.load(tmp_path / 'jax' / 'preview_5.npz')['arr_0']

    class JaxDraws(InlineEvalHook):
        def draw(self, step):
            key = jax.random.fold_in(jax.random.PRNGKey(self.seed), step)
            k_label, k_noise = jax.random.split(key)
            labels = jax.random.randint(k_label, (2,), 0, 10)
            z = jax.random.normal(k_noise, (2, 64, 16), jnp.float32)
            return (torch.from_numpy(np.array(labels, np.int64)),
                    torch.from_numpy(np.array(z)))

    model = FiT(**kw).eval()
    ema = state_dict_from_jax(params, depth=2, num_heads=4,
                              adaln_type='lora')
    hook = JaxDraws(model, SamplingConfig(**common, dtype=torch.float32),
                    every=5, out_dir=str(tmp_path / 'port'), seed=3
                    ).attach(lambda: ema)
    metrics = {}
    hook(3, metrics)
    assert not (tmp_path / 'port').exists()
    hook(5, metrics)
    got = np.load(tmp_path / 'port' / 'preview_5.npz')['arr_0']
    assert got.shape == want.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    assert 'inline_fid' not in metrics  # no reference, no VAE
    # the port's own draws: seeded from (seed, step), the same each call
    a, b = InlineEvalHook(model, SamplingConfig(**common), seed=3).draw(5), \
        InlineEvalHook(model, SamplingConfig(**common), seed=3).draw(5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].shape == (2, 64, 16)


def test_inline_eval_hook_fid_on_the_cpu(tmp_path):
    """With a VAE and a reference npz the hook adds a finite inline_fid /
    inline_is (seeded Inception on the CPU), and plugs into the trainer's
    metric_hook, reading the EMA from trainer.state."""
    from fitv2_tpu_torch.vae import AutoencoderKL
    torch.manual_seed(0)
    model = FiT(**dict(FIT, context_size=4, max_cached_len=4)).eval()
    vae = AutoencoderKL((8, 8, 8, 8)).eval()
    ref = str(tmp_path / 'ref.npz')
    np.savez(ref, arr_0=np.random.default_rng(0).integers(
        0, 255, (4, 32, 32, 3), np.uint8))
    hook = InlineEvalHook(model, SamplingConfig(
        image_height=32, image_width=32, num_sampling_steps=2,
        per_device_batch=2, num_classes=10, dtype=torch.float32),
        every=2, ref_images=ref, vae=vae, out_dir=str(tmp_path / 'p'))
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    hook.attach(lambda: ema)
    metrics = {}
    hook(2, metrics)
    assert np.isfinite(metrics['inline_fid']) and np.isfinite(
        metrics['inline_is'])
    preview = np.load(tmp_path / 'p' / 'preview_2.npz')['arr_0']
    assert preview.dtype == np.uint8 and preview.shape == (2, 32, 32, 3)


def test_inline_eval_hook_leaves_an_fp32_trainer_alone(tmp_path):
    """An fp32 Trainer's model holds its masters. With the hook as its
    metric_hook, given that model (an evaluation at step 2 of 3), the
    masters, the EMA and the moments equal bit for bit those of the same
    run without the hook, and the preview is written."""
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig
    root = str(tmp_path / 'data')
    make_synthetic_latent_shards(root, n=8, target_len=16, n_classes=10)
    states = []
    for with_hook in (False, True):
        torch.manual_seed(0)
        tr = Trainer(FiT(**FIT), TrainerConfig(
            data_path=root, target_len=16, global_batch_size=4,
            num_workers=1, learning_rate=1e-3, lr_schedule='constant',
            output_dir=str(tmp_path / f'run{with_hook}'),
            checkpointing_steps=100, log_every=1, seed=0, device='cpu',
            loader_backend='python', mixed_precision='no'))
        assert tr.model is tr.master_model
        hook = None
        if with_hook:
            hook = InlineEvalHook(tr.model, SamplingConfig(
                image_height=64, image_width=64, num_sampling_steps=2,
                per_device_batch=2, num_classes=10, dtype=torch.float32),
                every=2, out_dir=str(tmp_path / 'preview'))
            hook.attach(lambda: tr.state.ema_params)
        states.append(tr.train(max_steps=3, resume=False,
                               metric_hook=hook).state_dict())
    assert (tmp_path / 'preview' / 'preview_2.npz').exists()
    plain, hooked = states
    for key in ('params', 'ema_params'):
        for n, t in plain[key].items():
            assert torch.equal(t, hooked[key][n]), (key, n)
    for i, st in plain['optimizer']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, hooked['optimizer']['state'][i][k]), (i, k)
