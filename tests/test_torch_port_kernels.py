"""PyTorch port (fitv2_tpu_torch.kernels): the plain PyTorch versions of the
CUDA kernels against the JAX package's Pallas kernels (interpret mode on the
CPU) and reference chains, plus the device dispatch rules.

Inputs come from numpy with a seed and go to both packages. Tolerances are
fp32 ones: the two sides sum in different orders (reductions over <= 144
elements, attention over 16 keys), which moves results by a few ulps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu_torch import kernels as K
from fitv2_tpu_torch.kernels import _build

# fp32 results of the same math summed in another order
ATOL = RTOL = 2e-5
B, N, H, DH = 2, 16, 2, 72
N_VALID = 12


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _mask(valid=N_VALID):
    m = np.zeros((B, N), np.float32)
    m[:, :valid] = 1.0
    return m


def _ln(x):
    return (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + 1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


# -- K1: fused adaLN ---------------------------------------------------------

def test_adaln_plain_matches_pallas_and_reference():
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops.fused_adaln import _reference, fused_adaln_norm
    rng = _rng(1)
    d = 144
    # a large common offset across channels: the moments must not cancel
    x = (rng.standard_normal((B, N, d)) * 2 + 3.0).astype(np.float32)
    shift = rng.standard_normal((B, d)).astype(np.float32)
    scale = (rng.standard_normal((B, d)) * 0.1).astype(np.float32)
    ours = K.adaln_norm_reference(_t(x), _t(shift), _t(scale)).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = fused_adaln_norm(jnp.asarray(x), jnp.asarray(shift),
                                  jnp.asarray(scale), 1e-6, N)
    _close(ours, pallas)
    _close(ours, _reference(jnp.asarray(x), jnp.asarray(shift),
                            jnp.asarray(scale), 1e-6))
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(K.adaln_norm(_t(x), _t(shift), _t(scale)), _t(ours))


def test_adaln_plain_bf16_keeps_dtype():
    rng = _rng(2)
    x = torch.from_numpy(rng.standard_normal((B, N, 144)).astype(np.float32))
    mod = torch.from_numpy(rng.standard_normal((B, 2 * 144)).astype(
        np.float32))
    shift, scale = mod.chunk(2, dim=-1)
    out = K.adaln_norm(x.bfloat16(), shift.bfloat16(), scale.bfloat16())
    ref = K.adaln_norm(x, shift.bfloat16().float(), scale.bfloat16().float())
    assert out.dtype == torch.bfloat16
    # inputs rounded to bf16 move the fp32 result by ~2^-8 relative
    _close(out.float(), ref, atol=5e-2, rtol=2e-2)


# -- K2: fused q/k LayerNorm + RoPE -------------------------------------------

def _qk_inputs(seed=3):
    rng = _rng(seed)
    q = rng.standard_normal((B, N, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, N, H, DH)).astype(np.float32)
    ang = rng.uniform(0, 6.3, (B, N, DH)).astype(np.float32)
    return q, k, np.cos(ang), np.sin(ang)


@pytest.mark.parametrize('norm', [True, False])
def test_qk_rope_plain_matches_pallas_and_reference(norm):
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops.fused_qk_rope import _reference, fused_qk_rope
    q, k, cos, sin = _qk_inputs()
    oq, ok = K.qk_norm_rope_reference(_t(q), _t(k), _t(cos), _t(sin),
                                      norm_q=norm, norm_k=norm)
    jq, jk, jc, js = map(jnp.asarray, (q, k, cos, sin))
    with pltpu.force_tpu_interpret_mode():
        pq, pk = fused_qk_rope(jq, jk, jc, js, 1e-6, norm, norm, N)
    rq, rk = _reference(jq, jk, jc, js, 1e-6, norm, norm)
    for ours, pallas, ref in ((oq, pq, rq), (ok, pk, rk)):
        _close(ours.numpy(), pallas)
        _close(ours.numpy(), ref)


def test_qk_rope_accepts_strided_qkv_columns():
    """q/k as column blocks of the fused qkv projection (token stride 3C),
    the layout the Attention module hands over."""
    q, k, cos, sin = _qk_inputs(4)
    qkv = torch.stack([_t(q), _t(k), _t(q)], dim=2)  # (B, N, 3, H, Dh)
    qs, ks, _ = qkv.unbind(2)
    assert not qs.is_contiguous()
    a = K.qk_norm_rope(qs, ks, _t(cos), _t(sin))
    b = K.qk_norm_rope(_t(q), _t(k), _t(cos), _t(sin))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- K3 / K4: masked attention --------------------------------------------------

def _attn_inputs(seed=5, normed=False):
    rng = _rng(seed)
    q, k, v = (rng.standard_normal((B, N, H, DH)).astype(np.float32)
               for _ in range(3))
    if normed:  # the bounded-logit contract: no-affine LN on q and k
        q, k = _ln(q).astype(np.float32), _ln(k).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('masked', [False, True])
def test_online_attention_matches_flash_pallas(masked):
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops import flash_attention as fa
    from fitv2_tpu.ops.attention import _xla_masked_attention
    q, k, v = _attn_inputs()
    mask = _mask() if masked else None
    ours = K.attention_reference(_t(q), _t(k), _t(v),
                                 None if mask is None else _t(mask)).numpy()
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        pallas = fa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jm, N, N)
    ref = _xla_masked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jm, bounded_logits=False)
    _close(ours, pallas)
    _close(ours, ref)


@pytest.mark.parametrize('masked', [False, True])
def test_bounded_attention_matches_attention_core_pallas(masked):
    import fitv2_tpu.ops.attention_core as ac
    from fitv2_tpu.ops.attention import _xla_masked_attention
    q, k, v = _attn_inputs(6, normed=True)
    mask = _mask() if masked else None
    ours = K.attention_bounded_reference(
        _t(q), _t(k), _t(v), None if mask is None else _t(mask)).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    old = ac._INTERPRET
    ac._INTERPRET = True
    try:
        pallas = ac.attention_core(*(t.transpose(0, 2, 1, 3)
                                     for t in (jq, jk, jv)), jm)
    finally:
        ac._INTERPRET = old
    _close(ours, np.asarray(pallas).transpose(0, 2, 1, 3))
    _close(ours, _xla_masked_attention(jq, jk, jv, jm, bounded_logits=True))


@pytest.mark.parametrize('bounded', [False, True])
def test_masked_attention_dispatch_and_padding(bounded):
    """masked_attention on CPU tensors = the plain version of the variant;
    padded keys have no influence; padded query rows stay finite."""
    q, k, v = (_t(a) for a in _attn_inputs(7, normed=True))
    mask = _t(_mask())
    plain = K.attention_bounded_reference if bounded else K.attention_reference
    out = K.masked_attention(q, k, v, mask, bounded_logits=bounded)
    assert torch.equal(out, plain(q, k, v, mask))
    assert torch.isfinite(out).all()
    k2, v2 = k.clone(), v.clone()
    k2[:, N_VALID:] = 3.0
    v2[:, N_VALID:] = -77.0
    out2 = K.masked_attention(q, k2, v2, mask, bounded_logits=bounded)
    _close(out[:, :N_VALID], out2[:, :N_VALID], atol=1e-6, rtol=1e-6)
    # an all-ones mask is the same as no mask
    ones = torch.ones(B, N)
    _close(K.masked_attention(q, k, v, ones, bounded),
           K.masked_attention(q, k, v, None, bounded), atol=1e-6, rtol=1e-6)


def test_bounded_equals_online_for_layernormed_inputs():
    q, k, v = (_t(a) for a in _attn_inputs(8, normed=True))
    for m in (None, _t(_mask())):
        _close(K.attention_bounded_reference(q, k, v, m),
               K.attention_reference(q, k, v, m), atol=1e-5, rtol=1e-5)


# -- the kernel wrappers ----------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """A wrapper launches its CUDA kernel or raises: no silent fallback."""
    x = torch.zeros(B, N, 144)
    s = torch.zeros(B, 144)
    q = torch.zeros(B, N, H, DH)
    cs = torch.zeros(B, N, DH)
    before = [w.launches for w in K.KERNEL_WRAPPERS]
    with pytest.raises(ValueError, match='CUDA'):
        K.fused_adaln_norm(x, s, s)
    with pytest.raises(ValueError, match='CUDA'):
        K.fused_qk_rope(q, q, cs, cs)
    with pytest.raises(ValueError, match='CUDA'):
        K.flash_masked_attention(q, q, q)
    assert [w.launches for w in K.KERNEL_WRAPPERS] == before


def test_dispatchers_send_non_cpu_tensors_to_the_kernels():
    """A tensor off the CPU never takes the plain version: on a device the
    kernel does not support the wrapper raises."""
    x = torch.zeros(B, N, 144, device='meta')
    s = torch.zeros(B, 144, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        K.adaln_norm(x, s, s)
    q = torch.zeros(B, N, H, DH, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        K.masked_attention(q, q, q, None, bounded_logits=True)


def test_build_library_path_tracks_sources(monkeypatch, tmp_path):
    """The build directory is keyed by a hash of the CUDA sources; without
    nvcc the build raises instead of falling back."""
    assert {p.name for p in _build.sources()} >= {
        'adaln.cu', 'qk_rope.cu', 'attention.cu'}
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert path == _build.library_path()  # deterministic
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()
