"""PyTorch port, slice 7b: the LwD / BFM segment-flow train steps
(``train/lwd_train_step.py``, the finetune forward) against the JAX
package's on the same weights, batches and draws; the trainer, async saves
and ``cli/train_lwd`` are in test_torch_port_lwd_trainer.py.

The models are the LwD tests' small ones (``test_torch_port_lwd.SMALL``:
hidden 64, 4 heads, K 2, 4 x 4 patches) at one block a segment, with class
dropout 0.5 so that the replayed label drops matter; every parameter is
randomised on the JAX side and carried over by ``lwd_state_from_jax``
(JAX's state by ``train_state_from_jax``, its fp32 first moment included).
JAX draws x0, r and the label drops from ``split(fold_in(PRNGKey(seed),
state.step), 3)``; the tests rebuild them from those keys (the drops by
applying JAX's own label embedder with the drop key) and hand them to the
port through ``draws``. JAX's steps are jitted with XLA's backend
optimisation off.

Tolerances (fp32 on both sides; the frameworks sum in other orders):
- loss and gradient norm: 1e-5 relative;
- mu and nu: 1e-4 of each tensor's largest magnitude (the gradients
  summed in another order, as in test_torch_port_train);
- the parameters and the EMA: within 2e-6 (1e-5 of their scale), except
  where Adam's first step lr g / (|g| + eps) turns the two frameworks'
  rounding of a gradient near eps into a visible move: at most 1% of the
  elements, none more than 2 lr an update (test_torch_port_train's rule);
- the resizes: 1e-6 of the largest magnitude; the segment stream, the
  tiers and the corrected sigmas: exactly.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.fit_lwd_sharedenc import (
    FiTLwDSharedEncSepDec as JShared)
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.train import lwd_train_step as jlts
from fitv2_tpu.train import train_step as jts

from fitv2_tpu_torch.ckpt import (
    lwd_state_from_jax, state_dict_from_jax, train_state_from_jax)
from fitv2_tpu_torch.ckpt.convert import _find_state
from fitv2_tpu_torch.models import FiT, FiTLwD, FiTLwDSharedEncSepDec
from fitv2_tpu_torch.train import lwd_train_step as lts
from fitv2_tpu_torch.train import train_step as tts

from test_torch_port_lwd import SMALL, jax_and_port, randomize

LR = 1e-3
EMA = 0.9
SEED = 3
BATCH = 4
TOL_LOSS = 1e-5
TOL_MOMENT = 1e-4
TOL_PARAM = 2e-6
NO_OPT = {'xla_backend_optimization_level': 0}
KW = dict(SMALL, depth=2, class_dropout_prob=0.5)
REPA = dict(KW, number_of_representation_blocks=2, repa_dim=16)
SHARED = dict(KW, number_of_representation_blocks=1, repa_dim=16)
# 8 x 8 patches over K 3 segments of 1 block: tiers at N 4, 16 and 64
MULTI = dict(KW, context_size=64, n_patch_h=8, n_patch_w=8, depth=3,
             number_of_perflow=3)
MULTI_INDICES = (1, 2)
# BFM-XL's weighted RMSNorm q/k (one (Dh,) weight that every head shares):
# the tensor axis sums its gradient over the head split
RMS = dict(KW, q_norm='rmsnorm', k_norm='rmsnorm')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    a = np.asarray(torch.as_tensor(a).float() if isinstance(a, torch.Tensor)
                   else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


TX = jts.make_optimizer(jts.OptimizerConfig(learning_rate=LR))


_VARIANTS = {}


def variant(name):
    """(JAX model, randomised params, the port's model class, its keyword
    arguments, JAX's initial TrainState on the host) of a variant, built
    once a process."""
    if name not in _VARIANTS:
        specs = {'plain': (JFiTLwD, FiTLwD, KW),
                 'repa': (JFiTLwD, FiTLwD, REPA),
                 'shared': (JShared, FiTLwDSharedEncSepDec, SHARED),
                 'multi': (JFiTLwD, FiTLwD, MULTI),
                 'rms': (JFiTLwD, FiTLwD, RMS)}
        jcls, pcls, kw = specs[name]
        jm, params, _ = jax_and_port(jcls(**kw), pcls(**kw),
                                     seed=list(specs).index(name))
        init = jax.device_get(jax.jit(
            lambda p: jts.create_train_state(p, TX))(params))
        _VARIANTS[name] = (jm, params, pcls, kw, init)
    return _VARIANTS[name]


def _batch(jm, seed=0, repa_dim=None, batch=BATCH):
    """A full-grid batch (numpy): feature, grid, mask, label, size."""
    rng = np.random.default_rng(seed)
    n = jm.n_patch_h * jm.n_patch_w
    grid, mask, size = j_grid(batch, jm.n_patch_h, jm.n_patch_w, n)
    b = dict(feature=rng.standard_normal((batch, n, 16)).astype(np.float32),
             grid=np.asarray(grid), mask=np.asarray(mask),
             label=(np.arange(batch) * 3 % 10).astype(np.int32),
             size=np.asarray(size))
    if repa_dim:
        b['repa_target'] = rng.standard_normal(
            (batch, n, repa_dim)).astype(np.float32)
    return b


_DRAW_FNS = {}


def jax_step_draws(jm, params, step, segment, x_shape, seed=SEED,
                   drops=True):
    """JAX's draws of segment update ``step``: x0 of ``x_shape``, r (B,) and
    the label drops its embedder takes from the drop key (one jit a model,
    segment and shape)."""
    key = (id(jm), segment, x_shape, seed)
    if key not in _DRAW_FNS:
        e = segment if jm.perlayer_embedder else 0

        def draw(p, step):
            k_x0, k_r, k_drop = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(seed), step), 3)
            emb = jm.apply({'params': p}, jnp.arange(x_shape[0]) * 3 % 10,
                           method=lambda m, y: m._emb(m.y_embedders, segment)(
                               y, True), rngs={'label_dropout': k_drop})
            null = p[f'y_embedders_{e}']['embedding_table'][jm.num_classes]
            return (jax.random.normal(k_x0, x_shape, jnp.float32),
                    jax.random.uniform(k_r, (x_shape[0],), jnp.float32),
                    jnp.all(emb == null, axis=-1))
        _DRAW_FNS[key] = (jm, jax.jit(draw, compiler_options=NO_OPT))
    x0, r, drop = _DRAW_FNS[key][1](params, step)
    out = dict(x0=torch.from_numpy(np.array(x0)),
               r=torch.from_numpy(np.array(r)))
    if drops:
        out['drop_ids'] = torch.from_numpy(np.asarray(drop, np.int64))
    return out


def _jax_run(jm, params, init, make, batch, segments, seed=SEED):
    """JAX: one jitted update per segment from ``init``. Returns (the
    states after each update, metrics), on the host."""
    state = init
    fn = make(jm, TX)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(seed)
    states, metrics = [], []
    for k in segments:
        state, m = jax.jit(lambda s, b, r, k=k: fn(s, b, r, k),
                           compiler_options=NO_OPT)(state, jb, rng)
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
    return states, metrics


def _port_model(pcls, kw, init_np, jm):
    model = pcls(**kw)
    model.load_state_dict(lwd_state_from_jax(init_np.params, model),
                          strict=True)
    return model


def _compare(pstate, jstate, init, model, what=''):
    """The port's state against JAX's after the same updates."""
    assert pstate.step == int(jstate.step)
    adam = _find_state(jstate.opt_state, 'mu', 'nu', 'count')
    assert pstate.optimizer.param_groups[0]['count'] == int(adam.count)
    conv = {key: lwd_state_from_jax(tree, model) for key, tree in (
        ('params', jstate.params), ('ema', jstate.ema_params),
        ('mu', adam.mu), ('nu', adam.nu), ('init', init.params))}
    off = total = 0
    for n, p in pstate.params.items():
        st = pstate.optimizer.state[p]
        assert st['mu'].dtype == torch.float32, n
        for key in ('mu', 'nu'):
            assert _rel(st[key], conv[key][n]) <= TOL_MOMENT, (what, key, n)
        for key, ours in (('params', p), ('ema', pstate.ema_params[n])):
            diff = (ours.detach() - conv[key][n]).abs()
            assert diff.max() <= 2 * LR * pstate.step, (what, key, n)
            off += int((diff > TOL_PARAM).sum())
            total += diff.numel()
    assert off <= 0.01 * total, (what, off, total)


def _check_metrics(metrics, jm_):
    for k, v in jm_.items():
        assert abs(float(metrics[k]) - float(v)) <= TOL_LOSS * max(
            abs(float(v)), 1e-12), (k, float(metrics[k]), float(v))


# -- one JAX train_step per recipe against the port's -------------------------

@pytest.mark.parametrize('name,segments', [('plain', (0, 1)),
                                           ('repa', (1,))])
def test_reflow_steps_match_jax(name, segments):
    """Reflow updates on the given segments, without and with a REPA head
    and a batch ``repa_target``. With two updates, the second is on the
    other segment: segment 0's parameters get no gradient there, and Adam
    still moves them by their momentum in both packages (the zero
    gradients the port fills in)."""
    jm, params, pcls, kw, init = variant(name)
    batch = _batch(jm, repa_dim=kw.get('repa_dim') if name == 'repa'
                   else None)
    jstates, jmetrics = _jax_run(
        jm, params, init, lambda m, tx: jlts.make_lwd_train_step(
            m, tx, ema_decay=EMA, repa_weight=0.5), batch, segments)
    model = _port_model(pcls, kw, init, jm)
    state = train_state_from_jax(init, model, tts.OptimizerConfig(
        learning_rate=LR))
    step = lts.make_lwd_train_step(model, ema_decay=EMA, repa_weight=0.5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    drops = []
    for i, (k, js, jm_) in enumerate(zip(segments, jstates, jmetrics)):
        draws = jax_step_draws(jm, params, i, k, batch['feature'].shape)
        drops.append(draws['drop_ids'])
        before = {n: p.detach().clone() for n, p in state.params.items()}
        _, m = step(state, tb, k, draws=draws)
        _check_metrics(m, jm_)
        _compare(state, js, init, model, f'update {i} (segment {k})')
        if name == 'repa':
            assert float(m['proj_loss']) != 0.0
        if i == 1:  # segment 0 moved by its momentum alone
            name = 'segments.0.0.attn.qkv.weight'
            assert not torch.equal(before[name], state.params[name])
    drops = torch.cat(drops)
    assert 0 < int(drops.sum()) < len(drops) or name == 'repa'


def test_distill_step_matches_jax():
    """Distillation: the frozen FiT teacher (randomised, carried over) rolled
    over segment 1 in 2 Euler sub-steps, the student's reflow on it."""
    jm, params, pcls, kw, init = variant('plain')
    tkw = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=32,
               depth=2, num_heads=2, num_classes=10, learn_sigma=False,
               max_cached_len=8, adaln_type='lora', adaln_lora_dim=8)
    jt = JFiT(**tkw)
    g, m, s = j_grid(BATCH, 4, 4, 16)
    tparams = randomize(jax.eval_shape(
        jt.init, jax.random.PRNGKey(0), jnp.zeros((BATCH, 16, 16)),
        jnp.zeros((BATCH,)), jnp.zeros((BATCH,), jnp.int32), g, m, s)[
            'params'], seed=7)

    def jteacher(x, t, b):
        return jt.apply({'params': tparams}, x, t, b['label'], b['grid'],
                        b['mask'], b.get('size')).astype(jnp.float32)

    batch = _batch(jm, seed=1)
    (js,), (jm_,) = _jax_run(
        jm, params, init, lambda m_, tx: jlts.make_lwd_distill_step(
            m_, jteacher, tx, solver_steps=2, ema_decay=EMA), batch, (1,))
    teacher = FiT(**tkw)
    teacher.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tparams), depth=2, num_heads=2,
        adaln_type='lora'), strict=True)

    def pteacher(x, t, b):
        return teacher(x, t, b['label'], b['grid'], b['mask'],
                       b.get('size')).float()

    model = _port_model(pcls, kw, init, jm)
    state = train_state_from_jax(init, model, tts.OptimizerConfig(
        learning_rate=LR))
    step = lts.make_lwd_distill_step(model, pteacher, solver_steps=2,
                                     ema_decay=EMA)
    _, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  1, draws=jax_step_draws(jm, params, 0, 1,
                                          batch['feature'].shape))
    _check_metrics(met, jm_)
    _compare(state, js, init, model, 'distill')
    assert not any(p.grad is not None for p in teacher.parameters())


@pytest.mark.parametrize('mode', lts.FINETUNE_MODES)
def test_finetune_step_matches_jax(mode):
    """The forecaster's finetune on segment 1, each mode: the loss, every
    parameter, moment and EMA as JAX's; the shared encoder and the label
    table unchanged (no gradient, no momentum yet), the forecaster moved."""
    jm, params, pcls, kw, init = variant('shared')
    batch = _batch(jm, seed=2)
    (js,), (jm_,) = _jax_run(
        jm, params, init, lambda m, tx: jlts.make_lwd_finetune_step(
            m, tx, ema_decay=EMA, mode=mode), batch, (1,))
    model = _port_model(pcls, kw, init, jm)
    state = train_state_from_jax(init, model, tts.OptimizerConfig(
        learning_rate=LR))
    before = {n: p.detach().clone() for n, p in state.params.items()}
    step = lts.make_lwd_finetune_step(model, ema_decay=EMA, mode=mode)
    _, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  1, draws=jax_step_draws(jm, params, 0, 1,
                                          batch['feature'].shape,
                                          drops=False))
    _check_metrics(met, jm_)
    _compare(state, js, init, model, f'finetune {mode}')
    for n, p in state.params.items():
        if n.startswith(('shared_rep_blocks.', 'y_embedders.')):
            assert torch.equal(p, before[n]), n
    assert not torch.equal(state.params['mid_blocks.0.attn.qkv.weight'],
                           before['mid_blocks.0.attn.qkv.weight'])


@pytest.mark.parametrize('segment', [0, 1, 2], ids=['tier0', 'tier1',
                                                     'tier2'])
def test_multiscale_step_matches_jax(segment):
    """One multi-scale update per tier (N 4, 16, 64 of an 8 x 8 grid):
    JAX's x0 is drawn in the image layout, and so is the port's."""
    jm, params, pcls, kw, init = variant('multi')
    batch = _batch(jm, seed=3)
    (js,), (jm_,) = _jax_run(
        jm, params, init, lambda m, tx: jlts.make_lwd_multiscale_train_step(
            m, tx, ema_decay=EMA, multi_scale_indices=MULTI_INDICES),
        batch, (segment,))
    model = _port_model(pcls, kw, init, jm)
    state = train_state_from_jax(init, model, tts.OptimizerConfig(
        learning_rate=LR))
    step = lts.make_lwd_multiscale_train_step(
        model, ema_decay=EMA, multi_scale_indices=MULTI_INDICES)
    _, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  segment, draws=jax_step_draws(jm, params, 0, segment,
                                                (BATCH, 16, 16, 4)))
    assert float(met['tier']) == segment
    _check_metrics(met, jm_)
    _compare(state, js, init, model, f'multiscale segment {segment}')


def test_segment_step_refuses_a_detached_output(monkeypatch):
    """An adaLN output without a grad_fn leaves segment k's parameters
    upstream of it without a gradient: the step raises, naming them, and
    changes nothing."""
    from fitv2_tpu_torch.models import modules
    jm, params, pcls, kw, init = variant('plain')
    model = pcls(**kw)
    state = tts.create_train_state(model, tts.OptimizerConfig())
    before = {n: p.detach().clone() for n, p in state.params.items()}
    adaln = modules.adaln_norm
    monkeypatch.setattr(modules, 'adaln_norm',
                        lambda *a, **k: adaln(*a, **k).detach())
    step = lts.make_lwd_train_step(model)
    with pytest.raises(RuntimeError, match='no gradient for .*x_embedders'):
        step(state, {k: torch.from_numpy(v) for k, v in _batch(jm).items()},
             1, generator=torch.Generator().manual_seed(0))
    assert state.step == 0
    assert all(torch.equal(p, before[n]) for n, p in state.params.items())


# -- the pieces ---------------------------------------------------------------

def test_tiers_and_corrected_sigma_equal_jax():
    for s in (0.0, 1 / 3, 0.5, 2 / 3, 0.9):
        for gamma in (1 / 3, 0.5):
            assert lts._corrected_sigma(s, gamma) == \
                jlts._corrected_sigma(s, gamma)
    # tests/test_lwd_recipes.py's values
    np.testing.assert_allclose(lts._corrected_sigma(2 / 3), 0.5)
    for indices in ((2, 7), (1, 2), (3,)):
        assert [lts._tier_of(i, indices) for i in range(12)] == \
            [jlts._tier_of(i, indices) for i in range(12)]


@pytest.mark.parametrize('method,hw', [('bilinear', (8, 8)),
                                       ('bilinear', (4, 2)),
                                       ('nearest', (32, 32))])
def test_resize_matches_jax(method, hw):
    """bilinear down by 2 and 4 (antialias off) and nearest up by 2, NHWC."""
    img = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    if hw == (4, 2):
        img = img[:, :, :8]
    ref = np.asarray(jax.image.resize(jnp.asarray(img),
                                      (2, *hw, 4), method=method,
                                      antialias=False))
    out = lts.resize_nhwc(torch.from_numpy(img), *hw, method)
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-6


def test_segment_sampler_stream_equals_jax():
    ours, ref = lts.SegmentSampler(12, seed=42), jlts.SegmentSampler(12, 42)
    assert [ours() for _ in range(200)] == [ref() for _ in range(200)]
