"""PyTorch port, training (slice 5): the kernels' gradients, the transport,
AdamW + clipping + accumulation, the schedules and the EMA, two whole train
steps and the trainer, against the JAX package on the same numpy inputs.

A tiny FiTv2 (depth 2, hidden 64, 4 heads of Dh 16, SwiGLU, qk-LN,
adaLN-LoRA 16, context 16) trains on non-square synthetic latent shards
padded to 16 tokens. ``jax.random`` and torch streams never match, so both
packages get the same t, x0 and label-drop ids.

Tolerances:
- kernel gradients, fp32: 1e-5 of the largest |grad| (the same formulas
  summed in another order); bf16: 3e-2 of it (JAX's vjp rounds the bf16
  chain's intermediates, the RoPE products and the probabilities, where
  the port's backward keeps fp32 to the end);
- the port's autograd Functions (with the plain forward injected) against
  autograd of the plain versions: fp32 1e-5, bf16 3e-2, as above;
- optimizer on the same gradients: 1e-6 relative (AdamW's arithmetic in
  another order, optax's float32 ``decay ** count``); with a bf16 first
  moment under MultiSteps, 4 bf16 ulps of the moment's largest magnitude
  and 2e-2 lr on the parameters (XLA fuses that update and rounds
  ``b1 * mu`` at another place than optax's eager ops, which the port
  follows bit for bit);
- two fp32 train steps: loss and gradient norm 1e-5 relative, moments
  1e-4 of their largest magnitude; parameters within 2e-6 except where
  Adam's first step, about ``lr * sign(g)``, flips on a gradient that is
  0 to within the two frameworks' rounding (at most 1% of the elements,
  never more than 2 lr a step); bf16 compute: loss 2e-2 relative,
  gradient cosine > 0.99.
"""

import copy
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.data import latent_dataset as jld
from fitv2_tpu.flow import transport as jtransport
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.train import lr_scheduler as jlr
from fitv2_tpu.train import train_step as jts

from fitv2_tpu_torch.ckpt import state_dict_from_jax, train_state_from_jax
from fitv2_tpu_torch.data import make_synthetic_latent_shards
from fitv2_tpu_torch.flow import path as tpath
from fitv2_tpu_torch.flow import transport as ttransport
from fitv2_tpu_torch.kernels import fused_adaln as tk1
from fitv2_tpu_torch.kernels import flash_attention as tk34
from fitv2_tpu_torch.kernels import fused_attention as tk5
from fitv2_tpu_torch.models import FiT
from fitv2_tpu_torch.train import lr_scheduler as tlr
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig

import importlib
tk2 = importlib.import_module('fitv2_tpu_torch.kernels.fused_qk_rope')

B, N, H, DH = 2, 16, 4, 16
D = H * DH
N_VALID = 11
TOL_F32, TOL_BF16 = 1e-5, 3e-2
TINY = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=D,
            depth=2, num_heads=H, learn_sigma=False, use_sit=True,
            use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
            adaln_type='lora', adaln_lora_dim=16, num_classes=10,
            max_cached_len=16)
GOLD = np.load(os.path.join(os.path.dirname(__file__), 'goldens',
                            'transport.npz'))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel_err(ours, ref):
    ours = np.asarray(torch.as_tensor(ours).float() if isinstance(
        ours, torch.Tensor) else ours, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _tol(dtype):
    return TOL_F32 if dtype == 'fp32' else TOL_BF16


def _jdtype(dtype):
    return jnp.float32 if dtype == 'fp32' else jnp.bfloat16


def _tdtype(dtype):
    return torch.float32 if dtype == 'fp32' else torch.bfloat16


def _mask(valid=N_VALID):
    m = np.zeros((B, N), np.float32)
    m[0, :valid] = 1.0
    m[1, :valid - 4] = 1.0
    return m


def _jax_grads(fn, args, cot):
    """jax.grad of sum(fn(*args) * cot) (fn's output cast to fp32)."""
    def loss(*a):
        out = fn(*a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cot))
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _torch_grads(fn, leaves, cot):
    """Gradients of sum(fn(*leaves) * cot) for the leaf tensors."""
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o.float() * _t(c)).sum() for o, c in zip(outs, cot)).backward()
    return [x.grad for x in leaves]


def _leaf(a, dtype):
    return _t(a).to(_tdtype(dtype)).requires_grad_(True)


# -- K1-K5: the Functions' backward against jax.grad through the kernels ----

@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_adaln_gradients_match_jax(dtype):
    """K1: jax.grad through the Pallas kernel (interpret mode; its backward
    is the vjp of the reference chain) against the port's Function, with
    shift and scale strided chunks of one (B, 6D) modulation."""
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops.fused_adaln import fused_adaln_norm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, D)) * 2 + 3.0
    mod = rng.standard_normal((B, 6 * D)) * 0.5
    cot = [rng.standard_normal((B, N, D))]
    jd = _jdtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        jx, jsh, jsc = _jax_grads(
            lambda a, b, c: fused_adaln_norm(a, b, c, 1e-6, N),
            [jnp.asarray(x, jd), jnp.asarray(mod[:, :D], jd),
             jnp.asarray(mod[:, D:2 * D], jd)], cot)
    tx, tmod = _leaf(x, dtype), _leaf(mod, dtype)

    def fn(a, m):
        shift, scale = m.chunk(6, dim=-1)[:2]
        return tk1.AdaLNNorm.apply(a, shift, scale, 1e-6,
                                   tk1.adaln_norm_reference)
    gx, gmod = _torch_grads(fn, [tx, tmod], cot)
    assert gx.dtype == _tdtype(dtype)
    assert _rel_err(gx, jx) <= _tol(dtype)
    assert _rel_err(gmod[:, :D], jsh) <= _tol(dtype)
    assert _rel_err(gmod[:, D:2 * D], jsc) <= _tol(dtype)
    assert not gmod[:, 2 * D:].any()


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('norm_q', [True, False], ids=['norm_q', 'raw_q'])
def test_qk_rope_gradients_match_jax(dtype, norm_q):
    """K2 on strided q/k views of one qkv tensor (as in a block)."""
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops.fused_qk_rope import fused_qk_rope
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((B, N, 3, H, DH))
    ang = rng.uniform(0, 6.3, (B, N, DH)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    cot = [rng.standard_normal((B, N, H, DH)) for _ in range(2)]
    jd = _jdtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        jq, jk = _jax_grads(
            lambda a, b: fused_qk_rope(a, b, jnp.asarray(cos),
                                       jnp.asarray(sin), 1e-6, norm_q, True,
                                       N),
            [jnp.asarray(qkv[:, :, 0], jd), jnp.asarray(qkv[:, :, 1], jd)],
            cot)
    tqkv = _leaf(qkv, dtype)

    def fn(a):
        q, k, _ = a.unbind(2)
        return tk2.QKNormRope.apply(q, k, _t(cos), _t(sin), 1e-6, norm_q,
                                    True, tk2.qk_norm_rope_reference)
    (g,) = _torch_grads(fn, [tqkv], cot)
    assert _rel_err(g[:, :, 0], jq) <= _tol(dtype)
    assert _rel_err(g[:, :, 1], jk) <= _tol(dtype)
    assert not g[:, :, 2].any()


def _attn_inputs(rng, normed):
    q, k, v = (rng.standard_normal((B, N, H, DH)) for _ in range(3))
    if normed:  # the bounded-logit contract: LayerNormed q and k
        q, k = ((a - a.mean(-1, keepdims=True)) / a.std(-1, keepdims=True)
                for a in (q, k))
    return q, k, v


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('bounded', [False, True], ids=['K3', 'K4'])
def test_attention_gradients_match_jax(dtype, masked, bounded):
    """K3 (flash_masked_attention, explicit softmax gradients) and K4
    (attention_core, head-major, the vjp of its XLA core)."""
    from jax.experimental.pallas import tpu as pltpu
    import fitv2_tpu.ops.attention_core as ac
    from fitv2_tpu.ops.flash_attention import flash_masked_attention
    rng = np.random.default_rng(3)
    q, k, v = _attn_inputs(rng, normed=bounded)
    mask = _mask() if masked else None
    cot = [rng.standard_normal((B, N, H, DH))]
    jd = _jdtype(dtype)
    jm = None if mask is None else jnp.asarray(mask)
    args = [jnp.asarray(a, jd) for a in (q, k, v)]
    if bounded:
        def jfn(a, b, c):
            return ac.attention_core(
                *(t.transpose(0, 2, 1, 3) for t in (a, b, c)),
                jm).transpose(0, 2, 1, 3)
        old, ac._INTERPRET = ac._INTERPRET, True
        try:
            jg = _jax_grads(jfn, args, cot)
        finally:
            ac._INTERPRET = old
    else:
        with pltpu.force_tpu_interpret_mode():
            jg = _jax_grads(lambda a, b, c: flash_masked_attention(
                a, b, c, jm, N, N), args, cot)
    plain = (tk34.attention_bounded_reference if bounded
             else tk34.attention_reference)
    tm = None if mask is None else _t(mask)
    leaves = [_leaf(a, dtype) for a in (q, k, v)]
    tg = _torch_grads(lambda a, b, c: tk34.FlashMaskedAttention.apply(
        a, b, c, tm, bounded, lambda *x: plain(*x[:4])), leaves, cot)
    for ours, ref in zip(tg, jg):
        assert ours.dtype == _tdtype(dtype)
        assert _rel_err(ours, ref) <= _tol(dtype)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
def test_fused_attention_gradients_match_jax(dtype, masked, monkeypatch):
    """K5: the gradient of the flat qkv (padded query rows zeroed)."""
    import fitv2_tpu.ops.fused_attention as fa
    monkeypatch.setattr(fa, '_INTERPRET', True)
    rng = np.random.default_rng(4)
    qkv = rng.standard_normal((B, N, 3 * D))
    ang = rng.uniform(0, 6.3, (B, N, DH)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    mask = _mask() if masked else None
    cot = [rng.standard_normal((B, N, D))]
    jm = None if mask is None else jnp.asarray(mask)
    (jg,) = _jax_grads(lambda a: fa.fused_qkln_rope_attention(
        a, jnp.asarray(cos), jnp.asarray(sin), jm, H),
        [jnp.asarray(qkv, _jdtype(dtype))], cot)
    tm = None if mask is None else _t(mask)
    (tg,) = _torch_grads(lambda a: tk5.FusedQKLNRopeAttention.apply(
        a, _t(cos), _t(sin), tm, H, 1e-6, True, True,
        tk5.fused_qkln_rope_attention_reference), [_leaf(qkv, dtype)], cot)
    assert _rel_err(tg, jg) <= _tol(dtype)
    if masked:  # padded query rows of q carry no gradient
        assert not tg[0, N_VALID:, :D].any()


# -- the Functions with the plain forward injected, against autograd --------

def _function_cases():
    """By kernel: (Function call, plain call, input arrays)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, N, D)) * 2 + 3.0
    mod = rng.standard_normal((B, 6 * D)) * 0.5
    qkv5 = rng.standard_normal((B, N, 3, H, DH))
    ang = rng.uniform(0, 6.3, (B, N, DH)).astype(np.float32)
    cos, sin = _t(np.cos(ang)), _t(np.sin(ang))
    mask = _mask()
    mask[1] = 0.0  # a batch element with no valid token at all
    tm = _t(mask)

    def adaln(fwd):
        def call(a, m):
            shift, scale = m.chunk(6, dim=-1)[3:5]
            return fwd(a, shift, scale)
        return call

    def qk(fwd):
        def call(a):
            q, k, _ = a.unbind(2)
            return fwd(q, k)
        return call

    def attn(fwd):
        def call(a):
            return fwd(*a.unbind(2))
        return call

    cases = {
        'K1': (adaln(lambda a, s, c: tk1.AdaLNNorm.apply(
                   a, s, c, 1e-6, tk1.adaln_norm_reference)),
               adaln(tk1.adaln_norm_reference), [x, mod]),
        'K2': (qk(lambda q, k: tk2.QKNormRope.apply(
                   q, k, cos, sin, 1e-6, True, True,
                   tk2.qk_norm_rope_reference)),
               qk(lambda q, k: tk2.qk_norm_rope_reference(q, k, cos, sin)),
               [qkv5]),
        'K5': (lambda a: tk5.FusedQKLNRopeAttention.apply(
                   a, cos, sin, tm, H, 1e-6, True, True,
                   tk5.fused_qkln_rope_attention_reference),
               lambda a: tk5.fused_qkln_rope_attention_reference(
                   a, cos, sin, tm, H), [qkv5.reshape(B, N, 3 * D)]),
    }
    for bounded, name in ((False, 'K3'), (True, 'K4')):
        plain = (tk34.attention_bounded_reference if bounded
                 else tk34.attention_reference)
        for m, tag in ((None, ''), (tm, '+mask')):
            cases[name + tag] = (
                attn(lambda q, k, v, m=m, b=bounded, p=plain:
                     tk34.FlashMaskedAttention.apply(
                         q, k, v, m, b, lambda *a: p(*a[:4]))),
                attn(lambda q, k, v, m=m, p=plain: p(q, k, v, m)), [qkv5])
    return cases


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('kernel', ['K1', 'K2', 'K3', 'K3+mask', 'K4',
                                    'K4+mask', 'K5'])
def test_function_backward_matches_autograd_of_plain(dtype, kernel):
    """Each Function runs with its kernel's plain version injected as the
    forward: its ``*_backward`` against autograd through that plain
    version, including a batch element with no valid token (K3-K5)."""
    function, plain, arrays = _function_cases()[kernel]
    rng = np.random.default_rng(6)
    with torch.no_grad():
        out = plain(*[_t(a).to(_tdtype(dtype)) for a in arrays])
    outs = out if isinstance(out, tuple) else (out,)
    cot = [rng.standard_normal(tuple(o.shape)) for o in outs]
    ours = _torch_grads(function, [_leaf(a, dtype) for a in arrays], cot)
    ref = _torch_grads(plain, [_leaf(a, dtype) for a in arrays], cot)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert _rel_err(a, b.float().numpy()) <= _tol(dtype)


def test_dispatch_keeps_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version under autograd too: the
    Function (the kernel) is for CUDA tensors."""
    x = torch.randn(B, N, D, requires_grad=True)
    sh = torch.randn(B, D)
    out = tk1.adaln_norm(x, sh, sh)
    assert 'AdaLNNorm' not in type(out.grad_fn).__name__
    assert tk1.fused_adaln_norm.launches == 0


# -- transport -----------------------------------------------------------------

@pytest.mark.parametrize('name,plan', [('linear', tpath.ICPlan()),
                                       ('gvp', tpath.GVPCPlan()),
                                       ('vp', tpath.VPCPlan())])
def test_paths_match_the_golden(name, plan):
    x0, x1, t = _t(GOLD['x0']), _t(GOLD['x1']), _t(GOLD['t'])
    mask, pred = _t(GOLD['mask']), _t(GOLD['pred'])
    _, xt, ut = plan.plan(t, x0, x1)
    np.testing.assert_allclose(xt.numpy(), GOLD[f'xt_{name}'], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ut.numpy(), GOLD[f'ut_{name}'], rtol=1e-5,
                               atol=1e-6)
    mask_b, ratio = ttransport.masked_loss_ratio(mask, x1)
    loss = ttransport.mean_flat(((pred - ut) * mask_b) ** 2) * ratio
    np.testing.assert_allclose(loss.numpy(), GOLD[f'loss_{name}'],
                               rtol=1e-5)
    np.testing.assert_allclose(
        plan.get_score_from_velocity(pred, xt, t).numpy(),
        GOLD[f'score_from_v_{name}'], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('path_type,prediction,weight', [
    ('Linear', 'velocity', None), ('GVP', 'velocity', None),
    ('VP', 'velocity', None), ('Linear', 'noise', 'velocity'),
    ('Linear', 'score', 'likelihood'), ('VP', 'score', None)])
def test_training_losses_match_jax(path_type, prediction, weight):
    """The same t, x0, mask and model function in both packages: JAX's
    ``sample`` is replaced by the given draws."""
    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((3, 8, 4)).astype(np.float32)
    x0 = rng.standard_normal((3, 8, 4)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, 3).astype(np.float32)
    mask = np.ones((3, 8), np.float32)
    mask[1, 5:] = 0
    w = rng.standard_normal((4, 4)).astype(np.float32)
    ours = ttransport.create_transport(path_type, prediction, weight)
    ref = jtransport.create_transport(path_type, prediction, weight)
    assert ours.train_eps == ref.train_eps
    assert ours.check_interval(ours.train_eps, ours.sample_eps) == \
        ref.check_interval(ref.train_eps, ref.sample_eps)

    class Given(jtransport.Transport):
        def sample(self, rng_key, x):
            return jnp.asarray(t), jnp.asarray(x0), x

    jref = Given(**{f: getattr(ref, f) for f in (
        'model_type', 'path_type', 'loss_type', 'train_eps', 'sample_eps',
        'snr_type')})
    jout = jref.training_losses(
        jax.random.PRNGKey(0),
        lambda xt, tt: jnp.tanh(xt @ w) * tt[:, None, None],
        jnp.asarray(x1), mask=jnp.asarray(mask))
    tout = ours.training_losses(
        lambda xt, tt: torch.tanh(xt @ _t(w)) * tt[:, None, None],
        _t(x1), mask=_t(mask), t=_t(t), x0=_t(x0))
    np.testing.assert_allclose(tout['loss'].numpy(), jout['loss'],
                               rtol=1e-5)
    np.testing.assert_allclose(tout['pred'].numpy(), jout['pred'],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('snr', ['uniform', 'lognorm'])
def test_sampled_t_in_range_and_reproducible(snr):
    tr = ttransport.create_transport('Linear', 'velocity', snr_type=snr)
    x1 = torch.zeros(4096, 2, 3)
    t, x0, _ = tr.sample(x1, torch.Generator().manual_seed(0))
    assert ((t > 0) & (t < 1)).all() and x0.shape == x1.shape
    # lognorm: the sigmoid of a standard normal, centred on 1/2
    assert abs(t.mean().item() - 0.5) < 0.02
    if snr == 'lognorm':
        assert 0.18 < t.std().item() < 0.23  # sigmoid(N(0,1)): ~0.21
    t2, x02, _ = tr.sample(x1, torch.Generator().manual_seed(0))
    assert torch.equal(t, t2) and torch.equal(x0, x02)


# -- schedules, EMA, AdamW + clipping + accumulation against optax ----------

SCHEDULES = [
    ('constant', {}), ('constant_with_warmup', dict(num_warmup_steps=5)),
    ('linear', dict(num_warmup_steps=3, num_training_steps=20)),
    ('cosine', dict(num_warmup_steps=3, num_training_steps=20)),
    ('cosine_with_restarts', dict(num_warmup_steps=2, num_training_steps=20,
                                  num_cycles=3)),
    ('polynomial', dict(num_warmup_steps=4, num_training_steps=20,
                        power=2.0)),
    ('piecewise_constant', dict(step_rules='1:5,0.1:12,0.01')),
]


@pytest.mark.parametrize('name,kw', SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, kw):
    ours = tlr.get_scheduler(name, 3e-4, **kw)
    ref = jlr.get_scheduler(name, 3e-4, **kw)
    for step in (0, 1, 2, 3, 4, 5, 6, 11, 12, 13, 19, 20, 21, 40):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f'step {step}')
    if name == 'constant_with_warmup':
        assert ours(0) == 0.0  # the first update takes lr(0)


def test_update_ema_matches_jax_and_warns_in_bf16():
    rng = np.random.default_rng(8)
    e, p = (rng.standard_normal((5, 7)).astype(np.float32) for _ in range(2))
    ref = jts.update_ema({'a': jnp.asarray(e)}, {'a': jnp.asarray(p)}, 0.99)
    ema = {'a': _t(e)}
    tts.update_ema(ema, {'a': _t(p)}, 0.99)
    np.testing.assert_array_equal(ema['a'].numpy(), np.asarray(ref['a']))
    params = {'a': _t(p)}
    with pytest.warns(UserWarning, match='underflows'):
        tts.update_ema({'a': _t(e).bfloat16()}, params, 0.9999)
    np.testing.assert_array_equal(params['a'].numpy(), p)  # not touched


def _optax_run(params, grads_seq, lr, max_norm, mu_dtype, k):
    import optax
    tx = jts.make_optimizer(jts.OptimizerConfig(
        learning_rate=lr, max_grad_norm=max_norm, grad_accum_steps=k,
        mu_dtype=mu_dtype, lr_schedule=jlr.get_scheduler(
            'constant_with_warmup', lr, num_warmup_steps=2)))
    p = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(p)
    for g in grads_seq:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, p)
        p = optax.apply_updates(p, upd)
    adam = train_state_adam(state)
    return p, adam


def train_state_adam(opt_state):
    from fitv2_tpu_torch.ckpt.convert import _find_state
    return _find_state(opt_state, 'mu', 'nu', 'count')


@pytest.mark.parametrize('mu_dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('max_norm', [100.0, 0.5], ids=['unclipped',
                                                        'clipped'])
@pytest.mark.parametrize('steps,k', [(1, 1), (3, 1), (4, 2)],
                         ids=['1step', '3steps', 'multisteps2'])
def test_adamw_clip_matches_optax(mu_dtype, max_norm, steps, k):
    """The port's clip + AdamW (+ accumulation) on the same gradients as
    optax's chain: params, mu, nu and the count, with a warmup schedule
    (the first update uses lr(0) = 0)."""
    rng = np.random.default_rng(9)
    shapes = {'w': (6, 5), 'b': (5,), 'z': (3, 3)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads_seq = [{n: (rng.standard_normal(s) * 0.3).astype(np.float32)
                  for n, s in shapes.items()} for _ in range(steps)]
    lr = 1e-2
    jp, jadam = _optax_run(params, grads_seq, lr, max_norm,
                           jnp.bfloat16 if mu_dtype == 'bf16' else None, k)
    tp = {n: _t(v) for n, v in params.items()}
    opt = tts.AdamW(list(tp.values()), lr=tlr.get_scheduler(
        'constant_with_warmup', lr, num_warmup_steps=2),
        mu_dtype=torch.bfloat16 if mu_dtype == 'bf16' else None)
    acc = tts.GradAccumulator(k, list(tp.values())) if k > 1 else None
    for g in grads_seq:
        gs = [_t(g[n]) for n in tp]
        if acc is not None:
            gs = acc.update(gs)
            if gs is None:
                continue
        tts.clip_by_global_norm(gs, max_norm)
        for p, gg in zip(tp.values(), gs):
            p.grad = gg
        opt.step()
    assert opt.param_groups[0]['count'] == int(jadam.count) == steps // k
    # a bf16 first moment: optax's eager ops round b1 * mu in bf16, as the
    # port does (equal at k = 1); under MultiSteps XLA compiles the update
    # into one fused computation that rounds it elsewhere, a few bf16 ulps
    bf16 = mu_dtype == 'bf16'
    for i, (n, p) in enumerate(tp.items()):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]), rtol=1e-6,
                                   atol=lr * 2e-2 if bf16 else 1e-7,
                                   err_msg=n)
        st = opt.state[p]
        assert st['mu'].dtype == _tdtype(mu_dtype)
        mu_ref = np.asarray(jadam.mu[n], np.float32)
        np.testing.assert_allclose(
            st['mu'].float().numpy(), mu_ref, rtol=1e-6,
            atol=4 * 2 ** -8 * np.abs(mu_ref).max() if bf16 else 1e-8,
            err_msg=n)
        np.testing.assert_allclose(st['nu'].numpy(), np.asarray(jadam.nu[n]),
                                   rtol=1e-6, atol=1e-10, err_msg=n)


def test_adamw_state_round_trips_with_the_mu_dtype():
    p = torch.randn(4, 3)
    opt = tts.AdamW([p], lr=1e-3, mu_dtype=torch.bfloat16)
    p.grad = torch.randn(4, 3)
    opt.step()
    sd = copy.deepcopy(opt.state_dict())
    q = p.detach().clone()
    opt2 = tts.AdamW([q], lr=1e-3, mu_dtype=torch.bfloat16)
    opt2.load_state_dict(sd)
    assert opt2.state[q]['mu'].dtype == torch.bfloat16
    assert torch.equal(opt2.state[q]['mu'], opt.state[p]['mu'])
    assert opt2.param_groups[0]['count'] == 1


def test_updates_in_chunks_give_the_same_bits(monkeypatch):
    """AdamW (weight decay, bf16 mu) and the EMA over parameters split into
    several update chunks equal one update of them all, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(40, 30), (7,), (64, 16), (5, 5, 5), (300,)]
    runs = []
    for chunk_bytes in (1 << 30, 2048):
        monkeypatch.setattr(tts, 'UPDATE_CHUNK_BYTES', chunk_bytes)
        gen.manual_seed(3)
        ps = [torch.randn(s, generator=gen) for s in shapes]
        ema = {str(i): p.clone() for i, p in enumerate(ps)}
        opt = tts.AdamW(ps, lr=1e-2, weight_decay=0.1,
                        mu_dtype=torch.bfloat16)
        for _ in range(3):
            for p in ps:
                p.grad = torch.randn(p.shape, generator=gen)
            opt.step()
            tts.update_ema(ema, {str(i): p for i, p in enumerate(ps)}, 0.9)
        runs.append((ps, ema, [opt.state[p]['mu'] for p in ps]))
    assert len(list(tts.update_chunks(runs[1][0]))) == 4
    (ps_a, ema_a, mu_a), (ps_b, ema_b, mu_b) = runs
    for a, b in zip(ps_a + mu_a + list(ema_a.values()),
                    ps_b + mu_b + list(ema_b.values())):
        assert torch.equal(a, b)


# -- the slice: two train steps of the tiny FiTv2 against make_train_step ----

def _perturb_zero_init(params, seed=0, scale=0.05):
    """Seeded noise on the zero-initialised leaves (an untrained FiT
    outputs exactly 0 and gives most parameters no gradient)."""
    rng = np.random.default_rng(seed)

    def f(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + scale * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope='module')
def slice_setup(tmp_path_factory):
    """JAX params and a batch from the JAX loader on synthetic non-square
    shards padded to 16 tokens, with the draws both packages take."""
    root = str(tmp_path_factory.mktemp('slice'))
    jld.make_synthetic_latent_shards(root, n=8, target_len=16, n_classes=10,
                                     seed=1)
    loader = jld.INLatentLoader(root, target_len=16, batch_size=4,
                                num_workers=1)
    it = loader.train_dataloader(4, 1, 0, seed=0, process_index=0,
                                 process_count=1)
    it.use_native = False
    batch = next(iter(it))
    assert (batch['mask'].sum(1) < 16).any()  # padded, non-square grids
    rng = np.random.default_rng(10)
    draws = dict(t=rng.uniform(0.05, 0.95, 4).astype(np.float32),
                 x0=rng.standard_normal((4, 16, 16)).astype(np.float32),
                 drop_ids=np.array([0, 1, 0, 0], np.int32))
    jm = JFiT(**TINY)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                        train=True))(
        jb['feature'][:1], jnp.zeros((1,)), jb['label'][:1], jb['grid'][:1],
        jb['mask'][:1], jb['size'][:1])['params']
    return _perturb_zero_init(params), batch, draws


def _jax_steps(params, batch, draws, dtype, lr, steps=2):
    t, x0, drop = (jnp.asarray(draws[k]) for k in ('t', 'x0', 'drop_ids'))

    class Given(jtransport.Transport):
        def sample(self, rng_key, x):
            return t, x0, x

    jm = JFiT(**TINY, dtype=dtype)

    def apply_fn(p, x, tt, y, grid, mask, size, rngs=None):
        return jm.apply({'params': p}, x, tt, y, grid, mask, size,
                        train=True, force_drop_ids=drop)

    tx = jts.make_optimizer(jts.OptimizerConfig(learning_rate=lr))
    state = jts.create_train_state(params, tx)
    init = jax.device_get(state)
    step = jax.jit(jts.make_train_step(jm, Given(), tx, ema_decay=0.9,
                                       apply_fn=apply_fn))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, jb, jax.random.PRNGKey(0))
        metrics.append(jax.device_get(m))

    def loss(p):
        out = Given().training_losses(
            jax.random.PRNGKey(0),
            lambda xt, tt: apply_fn(p, xt, tt, jb['label'], jb['grid'],
                                    jb['mask'], jb['size']),
            jb['feature'], mask=jb['mask'])
        return jnp.mean(out['loss'])
    grads = jax.jit(jax.grad(loss))(params)
    return init, jax.device_get(state), metrics, grads


def _port_steps(init, batch, draws, compute_dtype, lr, steps=2):
    master = FiT(**TINY)
    cfg = tts.OptimizerConfig(learning_rate=lr)
    state = train_state_from_jax(init, master, cfg)
    model = master if compute_dtype == torch.float32 else \
        copy.deepcopy(master).to(compute_dtype)
    step = tts.make_train_step(model, ttransport.create_transport(),
                               cfg.max_grad_norm, ema_decay=0.9)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    td = {k: torch.from_numpy(v) for k, v in draws.items()}
    # the gradient at the initial parameters
    probe = copy.deepcopy(model)
    loss, _ = tts.flow_loss(probe, ttransport.create_transport(), tb,
                            draws=td)
    loss.backward()
    grads = {n: p.grad.float() for n, p in probe.named_parameters()}
    metrics = [step(state, tb, draws=td)[1] for _ in range(steps)]
    return state, metrics, grads


def _kw():
    return dict(depth=TINY['depth'], num_heads=H, adaln_type='lora')


def test_two_train_steps_match_jax_fp32(slice_setup):
    params, batch, draws = slice_setup
    lr = 1e-4
    init, jstate, jmetrics, jgrads = _jax_steps(params, batch, draws,
                                                jnp.float32, lr)
    state, metrics, grads = _port_steps(init, batch, draws, torch.float32,
                                        lr)
    for m, jm_ in zip(metrics, jmetrics):
        np.testing.assert_allclose(float(m['loss']), float(jm_['loss']),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m['grad_norm']),
                                   float(jm_['grad_norm']), rtol=1e-5)
    jg = state_dict_from_jax(jgrads, **_kw())
    for n, g in grads.items():
        assert _rel_err(g, jg[n].numpy()) <= 1e-5, n
    adam = train_state_adam(jstate.opt_state)
    mu, nu = (state_dict_from_jax(t, **_kw()) for t in (adam.mu, adam.nu))
    jp = state_dict_from_jax(jstate.params, **_kw())
    je = state_dict_from_jax(jstate.ema_params, **_kw())
    flips = total = 0
    for n, p in state.params.items():
        st = state.optimizer.state[p]
        assert _rel_err(st['mu'], mu[n].numpy()) <= 1e-4, n
        assert _rel_err(st['nu'], nu[n].numpy()) <= 1e-4, n
        diff = (p.detach() - jp[n]).abs()
        assert diff.max() <= 2 * 2 * lr, n  # two steps, each <= 2 lr apart
        flips += int((diff > 2e-6).sum())
        total += diff.numel()
        ediff = (state.ema_params[n] - je[n]).abs()
        assert ediff.max() <= 2 * 2 * lr, n
    assert flips <= 0.01 * total, (flips, total)
    assert state.step == int(jstate.step) == 2
    assert state.optimizer.param_groups[0]['count'] == int(adam.count)


def test_train_step_refuses_a_detached_kernel_output(slice_setup,
                                                     monkeypatch):
    """An adaLN output without a grad_fn (what every kernel wrapper gave
    before the autograd Functions) leaves the parameters upstream of it
    without a gradient: the train step raises, naming them, and trains
    on no zeros."""
    from fitv2_tpu_torch.models import modules
    params, batch, draws = slice_setup
    init = jax.device_get(jts.create_train_state(params, jts.make_optimizer(
        jts.OptimizerConfig(learning_rate=1e-4))))
    master = FiT(**TINY)
    state = train_state_from_jax(init, master, tts.OptimizerConfig())
    step = tts.make_train_step(master, ttransport.create_transport())
    before = {n: p.detach().clone() for n, p in state.params.items()}
    adaln = modules.adaln_norm
    monkeypatch.setattr(modules, 'adaln_norm',
                        lambda *a, **k: adaln(*a, **k).detach())
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    td = {k: torch.from_numpy(v) for k, v in draws.items()}
    with pytest.raises(RuntimeError, match='no gradient for .*x_embedder'):
        step(state, tb, draws=td)
    assert state.step == 0
    assert all(torch.equal(p, before[n]) for n, p in state.params.items())


def test_two_train_steps_bf16_compute_fp32_masters(slice_setup):
    """bf16 compute over fp32 masters against JAX's model in bf16 over its
    fp32 params: the losses of both steps and the initial gradient."""
    params, batch, draws = slice_setup
    _, _, jmetrics, jgrads = _jax_steps(params, batch, draws, jnp.bfloat16,
                                        1e-4)
    init = jax.device_get(jts.create_train_state(params, jts.make_optimizer(
        jts.OptimizerConfig(learning_rate=1e-4))))
    state, metrics, grads = _port_steps(init, batch, draws, torch.bfloat16,
                                        1e-4)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(e.dtype == torch.float32 for e in state.ema_params.values())
    for m, jm_ in zip(metrics, jmetrics):
        assert abs(float(m['loss']) / float(jm_['loss']) - 1) <= 2e-2
    jg = state_dict_from_jax(jgrads, **_kw())
    a = torch.cat([grads[n].flatten() for n in grads])
    b = torch.cat([jg[n].flatten() for n in grads])
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos > 0.99, cos


# -- the trainer ---------------------------------------------------------------

@pytest.fixture(scope='module')
def shard_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('shards'))
    make_synthetic_latent_shards(root, n=32, target_len=16, n_classes=10)
    return root


def _trainer(shard_dir, out, **kw):
    torch.manual_seed(0)
    cfg = dict(data_path=shard_dir, target_len=16, global_batch_size=8,
               num_workers=2, max_steps=6, learning_rate=1e-3,
               lr_schedule='constant', output_dir=out, checkpointing_steps=4,
               log_every=1, seed=0, device='cpu', loader_backend='python')
    cfg.update(kw)
    return Trainer(FiT(**TINY), TrainerConfig(**cfg))


def test_trainer_reduces_the_loss(tmp_path):
    """Four full-grid shards whose two flip variants are equal: every batch
    of 4 is the whole data set, which 30 steps overfit, as the JAX
    package's test_train_step_reduces_loss overfits one batch."""
    from fitv2_tpu_torch.data import safetensors_np
    root = str(tmp_path / 'data')
    make_synthetic_latent_shards(root, n=4, target_len=16, n_classes=10,
                                 square=True)
    sub = os.path.join(root, 'from_16_to_16')
    for f in os.listdir(sub):
        data = safetensors_np.load_file(os.path.join(sub, f))
        data['feature'][1] = data['feature'][0]
        safetensors_np.save_file(data, os.path.join(sub, f))
    losses = []
    tr = _trainer(root, str(tmp_path / 'run'), max_steps=30,
                  global_batch_size=4, learning_rate=3e-3,
                  checkpointing_steps=100, lr_warmup_steps=0,
                  lr_schedule='constant_with_warmup', loader_backend='native')
    state = tr.train(max_steps=30, resume=False,
                     metric_hook=lambda s, m: losses.append(m['loss']))
    assert state.step == 30 and len(losses) == 29
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.9 * np.mean(losses[:5]), losses
    assert tr.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.params.values())


def test_trainer_resume_is_bit_identical(shard_dir, tmp_path):
    """6 steps uninterrupted against 4 steps, a checkpoint, then a new
    trainer resumed to 6: parameters, EMA and moments equal bit for bit."""
    full = _trainer(shard_dir, str(tmp_path / 'a')).train(resume=False)
    _trainer(shard_dir, str(tmp_path / 'b')).train(max_steps=4, resume=False)
    resumed = _trainer(shard_dir, str(tmp_path / 'b')).train(max_steps=6)
    assert full.step == resumed.step == 6
    for n in full.params:
        assert torch.equal(full.params[n], resumed.params[n]), n
        assert torch.equal(full.ema_params[n], resumed.ema_params[n]), n
    a, b = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a['param_groups'] == b['param_groups']
    for i in a['state']:
        for key in ('mu', 'nu'):
            assert a['state'][i][key].dtype == b['state'][i][key].dtype
            assert torch.equal(a['state'][i][key], b['state'][i][key])
    assert a['state'][0]['mu'].dtype == torch.bfloat16


def test_trainer_resume_refuses_an_unreadable_checkpoint(shard_dir,
                                                         tmp_path):
    out = str(tmp_path / 'run')
    _trainer(shard_dir, out).train(max_steps=4, resume=False)
    path = os.path.join(out, 'checkpoints', 'checkpoint-4', 'train_state.pt')
    with open(path, 'wb') as f:
        f.write(b'not a checkpoint')
    with pytest.raises(RuntimeError, match='unreadable checkpoint'):
        _trainer(shard_dir, out).train(max_steps=6)


def test_trainer_preemption_writes_a_checkpoint_and_returns(shard_dir,
                                                            tmp_path):
    out = str(tmp_path / 'run')

    def hook(step, m):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    tr = _trainer(shard_dir, out, max_steps=50, checkpointing_steps=100)
    state = tr.train(resume=False, metric_hook=hook)
    assert tr.preempted and state.step == 3
    assert os.listdir(os.path.join(out, 'checkpoints')) == ['checkpoint-3']
    assert signal.getsignal(signal.SIGTERM) == before


def test_trainer_refuses_what_is_not_ported(shard_dir, tmp_path):
    out = str(tmp_path / 'run')
    # a 2-way fsdp axis does not resolve over one process (JAX's assert)
    for kw, err in ((dict(mesh_fsdp=2), AssertionError),
                    (dict(objective='vae'), ValueError),
                    (dict(mixed_precision='fp16'), ValueError)):
        with pytest.raises(err):
            _trainer(shard_dir, out, **kw)
    with pytest.raises(ValueError, match='adamw'):
        _trainer(shard_dir, out, optimizer='sgd')
    with pytest.raises(ValueError, match='inference-only'):
        Trainer(FiT(**TINY, gemm_precision='int8'),
                TrainerConfig(device='cpu'))


def _hr_xl_small(tmp_path, data_path, policy):
    """configs/fitv2_hr_xl.yaml (online decoupled NTK RoPE, remat per
    block) at TINY's width and depth under remat `policy`, batch 4 of
    16-token shards."""
    import yaml
    params = {k: TINY[k] for k in ('context_size', 'hidden_size', 'depth',
                                   'num_heads', 'adaln_lora_dim',
                                   'num_classes', 'max_cached_len')}
    params.update(remat_policy=policy, ori_max_pe_len=4)
    cfg = {'diffusion': {'network_config': {'params': params}},
           'data': {'params': {'train': {
               'data_path': data_path, 'target_len': 16,
               'loader': {'batch_size': 4, 'num_workers': 1}}}},
           'accelerate': {'lr_warmup_steps': 0, 'checkpointing_steps': 100}}
    path = str(tmp_path / f'{policy}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return [os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         'configs', 'fitv2_hr_xl.yaml'), path]


def test_cli_train_dots_offload_equals_dots(shard_dir, tmp_path):
    """cli/train on configs/fitv2_hr_xl.yaml cut small, two steps on the
    CPU under remat 'dots_offload' and under its 'dots' (bf16 over fp32
    masters): the checkpointed masters, EMA and moments equal bit for
    bit, and the saved products went to the host store and back."""
    from fitv2_tpu_torch.cli import train as cli_train
    from fitv2_tpu_torch.models import remat
    states = {}
    for policy in ('dots', 'dots_offload'):
        out = str(tmp_path / policy)
        remat.reset_counts()
        torch.manual_seed(0)
        cli_train.main(['--cfgdir', *_hr_xl_small(tmp_path, shard_dir,
                                                  policy),
                        '--device', 'cpu', '--max-steps', '2',
                        '--output-dir', out, '--no-resume'])
        states[policy] = torch.load(
            os.path.join(out, 'checkpoints', 'checkpoint-2',
                         'train_state.pt'), map_location='cpu')
        moved = dict(remat.counts)
        assert (moved['d2h_copies'] > 0) == (policy == 'dots_offload')
        assert moved['d2h_bytes'] == moved['h2d_bytes']
    a, b = states['dots'], states['dots_offload']
    assert a['step'] == b['step'] == 2
    for key in ('params', 'ema_params'):
        assert set(a[key]) == set(b[key])
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    for i, st in a['optimizer']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, b['optimizer']['state'][i][k]), (i, k)


def test_full_remat_gives_the_same_gradients():
    """use_checkpoint with remat_policy='full' recomputes each block in the
    backward pass: the same loss and gradients as without it."""
    torch.manual_seed(0)
    plain = FiT(**TINY)
    with torch.no_grad():
        for n, p in plain.named_parameters():
            if 'fc_out' in n or 'final_layer' in n:
                p.add_(0.05 * torch.randn_like(p))
    remat = FiT(**dict(TINY, use_checkpoint=True))
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(11)
    batch = dict(feature=_t(rng.standard_normal((2, 16, 16))),
                 grid=torch.from_numpy(np.asarray(
                     np.stack([np.indices((4, 4)).reshape(2, 16)] * 2),
                     np.int64)),
                 mask=torch.ones(2, 16), label=torch.tensor([1, 2]),
                 size=torch.tensor([[[4, 4]]] * 2))
    draws = dict(t=torch.tensor([0.3, 0.7]), x0=torch.randn(2, 16, 16),
                 drop_ids=torch.tensor([0, 1]))
    tr = ttransport.create_transport()
    grads = []
    for model in (plain, remat):
        loss, _ = tts.flow_loss(model, tr, batch, draws=draws)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0)


def test_label_dropout_draws_from_the_generator():
    table = FiT(**TINY).y_embedder
    labels = torch.arange(10).repeat(40)
    out = table(labels, train=True,
                generator=torch.Generator().manual_seed(0))
    dropped = (out == table.embedding_table[10]).all(-1)
    assert 0.05 < dropped.float().mean() < 0.16  # dropout_prob 0.1
    again = table(labels, train=True,
                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    forced = table(labels[:3], force_drop_ids=torch.tensor([1, 0, 1]))
    assert torch.equal(forced[0], table.embedding_table[10])
    assert torch.equal(table(labels), table.embedding_table[labels])


def test_cli_train_runs_two_steps_on_the_cpu(shard_dir, tmp_path):
    from fitv2_tpu_torch.cli import train as cli
    cfg = tmp_path / 'tiny.yaml'
    params = '\n'.join(f'      {k}: {v}' for k, v in TINY.items())
    cfg.write_text(f'''diffusion:
  network_config:
    target: fitv2_tpu.models.fit.FiT
    params:
{params}
  transport:
    path_type: Linear
    prediction: velocity
    snr_type: lognorm
data:
  params:
    train:
      data_path: {shard_dir}
      target_len: 16
      loader:
        batch_size: 4
        num_workers: 1
accelerate:
  learning_rate: 1.0e-4
  lr_warmup_steps: 10
  checkpointing_steps: 100
  checkpoints_total_limit: 2
  seed: 0
''')
    out = str(tmp_path / 'run')
    cli.main(['--cfgdir', str(cfg), '--device', 'cpu', '--max-steps', '2',
              '--output-dir', out, '--no-resume'])
    assert os.listdir(os.path.join(out, 'checkpoints')) == ['checkpoint-2']
    assert cli.parse_args(['--cfgdir', str(cfg)]).device == 'cuda'
    from fitv2_tpu_torch.train.came import CAME
    from fitv2_tpu_torch.utils.config import load_config
    args = cli.parse_args(['--cfgdir', str(cfg), '--came', '--device', 'cpu'])
    trainer = cli.build_trainer(load_config([str(cfg)]), args)
    assert isinstance(trainer.init_state().optimizer, CAME)


def test_metric_logger_and_tee(tmp_path, capsys):
    import json
    from fitv2_tpu_torch.utils.logging_utils import MetricLogger, Tee
    log = MetricLogger(str(tmp_path), use_tensorboard=False)
    log.log(3, {'loss': 1.5, 'grad_norm': 0.25})
    log.log(4, {'loss': 1.25})
    log.close()
    recs = [json.loads(line) for line in
            (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert [r['step'] for r in recs] == [3, 4]
    assert recs[0]['loss'] == 1.5 and recs[0]['grad_norm'] == 0.25
    tee = Tee(str(tmp_path / 'out.txt'))
    print('to both')
    tee.close()
    assert 'to both' in capsys.readouterr().out
    assert (tmp_path / 'out.txt').read_text() == 'to both\n'
