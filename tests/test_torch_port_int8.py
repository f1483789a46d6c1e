"""PyTorch port, int8 W8A8 serving (fitv2_tpu_torch.kernels.int8_gemm /
quant, the quantized FiT and sampler) against the JAX package.

The two GEMM kernels' plain versions run against the Pallas kernels of
fitv2_tpu/ops/int8_gemm.py in interpret mode, on the shapes of
tests/test_int8_gemm.py. A small int8 FiT (hidden 128, 2 heads, SwiGLU
hidden 256, 8 x 64 tokens = 512 GEMM rows, so every JAX shape gate passes)
runs in both packages on the same numpy inputs, with JAX's calibration and
int8 weights carried over by ``quant_state_from_jax``.

Tolerances, each with its reason:
  - GEMM epilogues: the int32 accumulators are exact and both sides run the
    same f32 epilogue; an FMA contraction may move the f32 result by 1 ulp,
    so bf16 outputs agree to 1 bf16 ulp (rtol 8e-3) and fp32 without bias
    exactly.
  - SwiGLU requantization: the sigmoid may differ by 1 f32 ulp between
    implementations, which can flip a rounding tie: at most 1 level on
    under 1% of the elements (tests/test_int8_gemm.py's own bound).
  - quantization of identical f32 inputs: exact.
  - the int8 FiT in fp32: upstream fp32 differences of ~1e-7 (summation
    order) move an activation across an int8 rounding boundary now and
    then; one such flip changes its GEMM's whole output row by one
    quantization step (a single flip at the first qkv is 1.3e-4 of that
    GEMM's output), and attention spreads it. Relative L2 2e-3 against JAX
    with its fused kernels; 4e-3 against its default XLA path, whose
    SwiGLU rounds fc1's output to the model dtype before silu * v (the
    same values in fp32, as here); 5e-3 after three sampler steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fitv2_tpu.ops.int8_gemm as ig
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.ops import quant as jquant
from fitv2_tpu.sample import SamplingConfig as JSamplingConfig
from fitv2_tpu.sample import build_sampler as j_build_sampler

from fitv2_tpu_torch.ckpt import quant_state_from_jax, state_dict_from_jax
from fitv2_tpu_torch.kernels import int8_gemm as pig
from fitv2_tpu_torch.kernels import quant as pquant
from fitv2_tpu_torch.models import FiT
from fitv2_tpu_torch.models import modules as pmodules
from fitv2_tpu_torch.sample import SamplingConfig, build_sampler

INT8 = dict(context_size=64, patch_size=2, in_channels=4, hidden_size=128,
            depth=2, num_heads=2, mlp_ratio=3.0, learn_sigma=False,
            use_sit=True, use_swiglu=True, q_norm='layernorm',
            k_norm='layernorm', adaln_type='lora', adaln_lora_dim=32,
            num_classes=10, max_cached_len=16, gemm_precision='int8')
BATCH = 8  # x 64 tokens = 512 GEMM rows


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_fused(monkeypatch):
    """JAX with its fused int8 kernels on (interpret mode); counts their
    calls, so a test can assert that the kernel path was really taken."""
    calls = {'bias': 0, 'swiglu': 0}
    ob, osw = ig.int8_gemm_bias, ig.int8_gemm_swiglu_quant

    def bias(*a, **k):
        calls['bias'] += 1
        return ob(*a, **k)

    def swiglu(*a, **k):
        calls['swiglu'] += 1
        return osw(*a, **k)
    monkeypatch.setattr(ig, '_INTERPRET', True)
    monkeypatch.setattr(ig, 'int8_gemm_bias', bias)
    monkeypatch.setattr(ig, 'int8_gemm_swiglu_quant', swiglu)
    old = jquant.use_fused_kernels
    jquant.set_fused_kernels(True)
    try:
        yield calls
    finally:
        jquant.set_fused_kernels(old)


def _gemm_inputs(m, k, n, seed):
    """int8 operands in both layouts: xq (M, K), wq (K, N) for JAX and its
    transpose (N, K) for the port, f32 scale and bias (N,)."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, n) * 1e-4).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return xq, wq, scale, bias


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('m,k,n,out_dtype,with_bias', [
    (512, 160, 256, 'bfloat16', True),
    (1024, 96, 384, 'float32', False),
    (512, 64, 3072, 'bfloat16', True),   # several N tiles
], ids=['bf16_bias', 'fp32_no_bias', 'multi_tile_n'])
def test_gemm_bias_plain_matches_pallas(monkeypatch, m, k, n, out_dtype,
                                        with_bias):
    monkeypatch.setattr(ig, '_INTERPRET', True)
    xq, wq, scale, bias = _gemm_inputs(m, k, n, seed=m + k + n)
    jb = jnp.asarray(bias) if with_bias else None
    want = np.asarray(ig.int8_gemm_bias(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale), jb,
        out_dtype=getattr(jnp, out_dtype)), np.float32)
    got = pig.int8_gemm_bias_reference(
        _t(xq), _t(wq.T), _t(scale), _t(bias) if with_bias else None,
        getattr(torch, out_dtype)).float().numpy()
    if out_dtype == 'float32':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-6)


def test_gemm_swiglu_quant_plain_matches_pallas(monkeypatch):
    monkeypatch.setattr(ig, '_INTERPRET', True)
    m, k, two_h = 512, 96, 512
    xq, wq, scale, bias = _gemm_inputs(m, k, two_h, seed=3)
    scale = scale * 0.3
    osr = np.float32(1.0) / np.float32(0.037)
    want = np.asarray(ig.int8_gemm_swiglu_quant(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
        jnp.asarray(bias), jnp.float32(osr)), np.int32)
    got = pig.int8_gemm_swiglu_quant_reference(
        _t(xq), _t(wq.T), _t(scale), _t(bias), float(osr))
    assert got.dtype == torch.int8 and got.shape == (m, two_h // 2)
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert (want != 0).mean() > 0.5  # the comparison is not vacuous
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_dispatchers_take_the_plain_version_on_cpu():
    xq, wq, scale, bias = _gemm_inputs(64, 32, 48, seed=5)
    args = (_t(xq), _t(wq.T), _t(scale), _t(bias))
    assert torch.equal(pig.dequant_gemm(*args, torch.float32),
                       pig.int8_gemm_bias_reference(*args, torch.float32))
    assert torch.equal(pig.swiglu_requant_gemm(*args, 3.0),
                       pig.int8_gemm_swiglu_quant_reference(*args, 3.0))
    launches = (pig.int8_gemm_bias.launches,
                pig.int8_gemm_swiglu_quant.launches)
    with pytest.raises(ValueError, match='CUDA'):
        pig.int8_gemm_bias(*args)
    with pytest.raises(ValueError, match='CUDA'):
        pig.int8_gemm_swiglu_quant(*args, 3.0)
    assert (pig.int8_gemm_bias.launches,
            pig.int8_gemm_swiglu_quant.launches) == launches


@pytest.mark.parametrize('axis', [0, 1])
def test_quantize_symmetric_matches_jax(axis):
    x = np.random.default_rng(axis).standard_normal((96, 160)).astype(
        np.float32) * 3.0
    x[5] = 0.0  # an all-zero row takes the 1e-12 floor
    jq, js = jquant.quantize_symmetric(jnp.asarray(x), axis=axis)
    pq, ps = pquant.quantize_symmetric(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize('mode', ['dynamic', 'static'])
def test_int8_matmul_matches_jax(mode):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 80)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(80).astype(np.float32)
    jwq, jws = jquant.quantize_symmetric(jnp.asarray(w), axis=0)
    act = np.float32(np.abs(x).max() / 127.0) if mode == 'static' else None
    want = np.asarray(jquant.int8_matmul(
        jnp.asarray(x), jwq, jws, jnp.asarray(bias), out_dtype=jnp.float32,
        act_scale=None if act is None else jnp.float32(act)))
    pwq, pws = pquant.quantize_symmetric(torch.from_numpy(w.T.copy()), 1)
    got = pquant.int8_matmul(
        torch.from_numpy(x), pwq, pws.reshape(-1), torch.from_numpy(bias),
        out_dtype=torch.float32,
        act_scale=None if act is None else torch.tensor(act)).numpy()
    assert got.shape == want.shape == (4, 32, 80)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_linear_keeps_linear_params_and_fp32_scales():
    lin = pquant.Int8Linear(32, 48)
    assert set(lin.state_dict()) == {'weight', 'bias'}
    pquant.calibrate_quant_scales(lin, [(torch.randn(4, 32),)])
    pquant.prequantize_weights(lin)
    assert lin.weight_q.dtype == torch.int8 and lin.weight_q.shape == (48, 32)
    lin = lin.to(torch.bfloat16)
    assert lin.weight.dtype == torch.bfloat16
    assert lin.w_scale.dtype == lin.act_absmax.dtype == torch.float32
    assert lin.weight_q.dtype == torch.int8
    assert set(lin.state_dict()) == {'weight', 'bias'}
    with pytest.raises(KeyError, match='no such Int8Linear buffer'):
        pquant.load_quant_state(lin, {'fc.weight_q': lin.weight_q})


# ---------------------------------------------------------------------------
# the int8 FiT
# ---------------------------------------------------------------------------

def _randomize(params, seed=7, scale=0.05):
    """Random every leaf (an untrained FiT outputs exactly 0)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        scale * jax.random.normal(k, l.shape, l.dtype)
        for k, l in zip(keys, leaves)])


def _inputs(batch, seed, n_h=8, n_w=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 64, 16)).astype(np.float32)
    t = rng.uniform(size=batch).astype(np.float32)
    y = rng.integers(0, 11, size=batch)
    g, m, s = j_grid(batch, n_h, n_w, 64)
    return x, t, y, np.array(g), np.array(m), np.array(s)


@pytest.fixture(scope='module')
def int8_models():
    """JAX int8 FiT + random params + its calibration and int8 weights, and
    the port FiT with the same weights and JAX's quantization state."""
    jm = JFiT(**INT8)
    x, t, y, g, m, s = _inputs(BATCH, seed=0)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(t), jnp.asarray(y), g, m,
                                s)['params'])
    calib_batches = [tuple(jnp.asarray(a) for a in _inputs(BATCH, seed=sd))
                     for sd in (1, 2)]
    collections = {
        'quant_calib': jquant.calibrate_quant_scales(jm, params,
                                                     calib_batches),
        'quant_weights': jquant.prequantize_weights(jm, params,
                                                    calib_batches[0])}
    cnp = jax.tree_util.tree_map(np.asarray, collections)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    pm = FiT(**INT8)
    pm.load_state_dict(state_dict_from_jax(pnp, depth=2, num_heads=2,
                                           adaln_type='lora'))
    qstate = quant_state_from_jax(cnp, depth=2)
    pquant.load_quant_state(pm, qstate)
    return jm, params, collections, pm.eval(), pnp, qstate


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_quant_state_from_jax_round_trip(int8_models):
    _, _, _, pm, pnp, qstate = int8_models
    layers = pquant.int8_layers(pm)
    assert set(layers) == {f'blocks.{i}.{s}' for i in range(2) for s in (
        'attn.qkv', 'attn.proj', 'mlp.fc1', 'mlp.fc2')}
    assert set(qstate) == {f'{n}.{b}' for n in layers
                           for b in pquant.QUANT_BUFFERS}
    assert qstate['blocks.1.mlp.fc1.weight_q'].shape == (512, 128)
    assert qstate['blocks.1.mlp.fc1.w_scale'].shape == (512,)
    assert qstate['blocks.1.mlp.fc1.act_absmax'].shape == ()
    # JAX's int8 weights are the port's own quantization of the same
    # weights. JAX's compiled graph turns the division absmax / 127 into a
    # multiply by f32(1 / 127), so a scale may differ by 1 ulp, and an
    # element on a rounding tie by one level.
    fresh = FiT(**INT8)
    fresh.load_state_dict(pm.state_dict())
    mine = pquant.prequantize_weights(fresh)
    for name, t in mine.items():
        if name.endswith('w_scale'):
            np.testing.assert_allclose(t.numpy(), qstate[name].numpy(),
                                       rtol=2.4e-7, err_msg=name)
        else:
            diff = (t.int() - qstate[name].int()).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
    # and load back unchanged
    pquant.load_quant_state(fresh, qstate)
    for name, lin in pquant.int8_layers(fresh).items():
        for b in pquant.QUANT_BUFFERS:
            assert torch.equal(getattr(lin, b), qstate[f'{name}.{b}'])


def test_calibration_matches_jax(int8_models):
    jm, params, collections, pm, _, qstate = int8_models
    fresh = FiT(**INT8)
    fresh.load_state_dict(pm.state_dict())
    batches = [tuple(torch.from_numpy(np.asarray(a))
                     for a in _inputs(BATCH, seed=sd)) for sd in (1, 2)]
    got = pquant.calibrate_quant_scales(fresh, batches)
    assert set(got) == {k for k in qstate if k.endswith('act_absmax')}
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), qstate[name].numpy(),
                                   rtol=1e-5, err_msg=name)


def _forward_both(int8_models):
    jm, params, collections, pm, _, _ = int8_models
    x, t, y, g, m, s = _inputs(BATCH, seed=4, n_h=7, n_w=8)  # padded
    variables = {'params': params, **collections}
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(y), g, m, s))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(np.asarray(a))
                   for a in (x, t, y, g, m, s))).numpy()
    return got, want


def test_int8_fit_matches_jax_fused_kernels(int8_models, pallas_fused,
                                            monkeypatch):
    calls = []
    orig = pmodules.swiglu_requant_gemm
    monkeypatch.setattr(pmodules, 'swiglu_requant_gemm',
                        lambda *a: calls.append(1) or orig(*a))
    got, want = _forward_both(int8_models)
    # JAX took its kernel path (traced once per scanned block body) and the
    # port its fused SwiGLU in both blocks
    assert pallas_fused['bias'] >= 3 and pallas_fused['swiglu'] >= 1
    assert len(calls) == 2
    assert np.abs(want).max() > 0.1
    assert _rel(got, want) < 2e-3, _rel(got, want)


def test_int8_fit_close_to_jax_default_path(int8_models):
    got, want = _forward_both(int8_models)
    assert _rel(got, want) < 4e-3, _rel(got, want)


def test_int8_forward_close_to_dense(int8_models):
    """Same weights, int8 vs fp32 GEMMs: the velocity keeps its direction
    (cosine > 0.99, the JAX package's own bound)."""
    _, _, _, pm, _, _ = int8_models
    dense = FiT(**dict(INT8, gemm_precision='bf16'))
    dense.load_state_dict(pm.state_dict())
    args = tuple(torch.from_numpy(np.asarray(a))
                 for a in _inputs(BATCH, seed=6))
    with torch.no_grad():
        a = dense(*args).double().ravel()
        b = pm(*args).double().ravel()
    assert float(a @ b / (a.norm() * b.norm())) > 0.99


def test_int8_sampler_with_jax_collections_matches_jax(int8_models):
    jm, params, collections, pm, _, qstate = int8_models
    kw = dict(image_height=128, image_width=128, num_sampling_steps=3,
              cfg_scale=1.5, num_classes=10, per_device_batch=4)
    jfn = j_build_sampler(jm, params, JSamplingConfig(dtype=jnp.float32,
                                                       **kw),
                          quant_collections=collections)
    rng = jax.random.PRNGKey(5)
    labels = np.array([1, 4, 9, 10])
    want = np.asarray(jfn(rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (4, 64, 16), jnp.float32))
    pfn = build_sampler(pm, SamplingConfig(dtype=torch.float32, **kw),
                        quant_collections=qstate)
    got = pfn(torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (4, 4, 16, 16)
    z_img = pm.unpatchify(torch.from_numpy(z), (16, 16)).numpy()
    assert np.abs(want - z_img).max() > 0.05
    assert _rel(got - z_img, want - z_img) < 5e-3


def test_int8_sampler_calibrates_itself(int8_models):
    _, _, _, pm, _, _ = int8_models
    model = FiT(**INT8)
    model.load_state_dict(pm.state_dict())
    kw = dict(image_height=128, image_width=112, num_sampling_steps=2,
              num_classes=10, per_device_batch=2, dtype=torch.float32)
    fn = build_sampler(model.eval(), SamplingConfig(**kw))
    for name, lin in pquant.int8_layers(model).items():
        assert lin.weight_q is not None and lin.act_absmax > 0, name
        assert lin.quant_parts() is not None
    z = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(1))
    out = fn(torch.tensor([3, 7]), z=z)
    dense = FiT(**dict(INT8, gemm_precision='bf16'))
    dense.load_state_dict(pm.state_dict())
    ref = build_sampler(dense.eval(), SamplingConfig(**kw))(
        torch.tensor([3, 7]), z=z)
    z_img = model.unpatchify(z[:, :56], (16, 14))
    a, b = (out - z_img).double().ravel(), (ref - z_img).double().ravel()
    assert torch.isfinite(out).all()
    assert float(a @ b / (a.norm() * b.norm())) > 0.99
    assert fn.config_fingerprint != build_sampler(
        dense, SamplingConfig(**kw)).config_fingerprint
