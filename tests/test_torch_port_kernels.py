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


def _bf16(a):
    """numpy fp32 -> numpy bf16 (ml_dtypes), the same bits torch rounds to."""
    import ml_dtypes
    return np.asarray(a, ml_dtypes.bfloat16)


def _bf16_agreement(ours, ref):
    """bf16 outputs: max |ours - ref| in bf16 ulps of max |ref| (the card
    tests' unit), and the share of elements that differ at all."""
    ours = np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    diff = np.abs(ours - ref)
    return diff.max() / ulp, (diff > 0).mean()


# bf16: within 1 ulp of the output's largest magnitude, and at most 1% of
# the elements differing at all (an fp32 statistic summed in another order
# may flip one rounding; a chain that rounded at other places would differ
# in a large share of the elements)
BF16_ULPS, BF16_SHARE = 1.0, 1e-2


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


@pytest.mark.parametrize('d', [1152, 2304])
def test_adaln_plain_bf16_matches_pallas(d):
    """The rounding the CUDA kernel is held to, in bf16: the plain version
    (fp32 moments and epilogue, one rounding to bf16) against the JAX
    package's Pallas kernel in interpret mode on the same bf16 inputs, at
    the XL and 3B widths. A large common offset, as the residual stream
    carries."""
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops.fused_adaln import fused_adaln_norm
    rng = _rng(20)
    x = _bf16(rng.standard_normal((B, N, d)) * 2 + 3.0)
    mod = _bf16(rng.standard_normal((B, 6 * d)) * 0.5)
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    tx, tmod = (_t(a.astype(np.float32)).bfloat16() for a in (x, mod))
    ours = K.adaln_norm_reference(tx, tmod[:, :d], tmod[:, d:2 * d])
    assert ours.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        pallas = fused_adaln_norm(jnp.asarray(x), jnp.asarray(shift),
                                  jnp.asarray(scale), 1e-6, N)
    assert pallas.dtype == jnp.bfloat16
    ulps, share = _bf16_agreement(ours.float().numpy(),
                                  pallas.astype(jnp.float32))
    assert ulps <= BF16_ULPS and share <= BF16_SHARE, (ulps, share)


@pytest.mark.parametrize('d,offset,stride,want', [
    (1152, 0, 6 * 1152, True), (2304, 0, 6 * 2304, True),
    (128, 0, 2 * 128, True), (384, 0, 6 * 384, True),
    (144, 0, 6 * 144, False),              # no vector instantiation
    (1152, 1, 6 * 1152 + 1, False),        # odd element start and stride
    (1152, 2, 6 * 1152 + 2, False),        # 4 bytes off in bf16
    (1152, 4, 6 * 1152 + 4, True),         # 4 elements off: still aligned
])
def test_adaln_vector_path_choice(d, offset, stride, want):
    """The wrapper's host-side choice of instantiation: the vector one for
    the model widths on 4-element boundaries (the modulation's column
    chunks in a block), the scalar one otherwise; bf16 and fp32 alike
    (4 elements are 8 and 16 bytes)."""
    from fitv2_tpu_torch.kernels.fused_adaln import vector_path
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(B, N, d, dtype=dtype)
        mod = torch.zeros(B, stride, dtype=dtype)
        shift = mod[:, offset:offset + d]
        scale = mod[:, offset + d:offset + 2 * d]
        assert vector_path(x, shift, scale) == want, (d, offset, dtype)
    # x itself off the boundary (a contiguous view one element in)
    flat = torch.zeros(B * N * 1152 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(B, N, 1152)
    mod = torch.zeros(B, 6 * 1152, dtype=torch.bfloat16)
    assert not vector_path(x, mod[:, :1152], mod[:, 1152:2304])


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


@pytest.mark.parametrize('norm_q', [True, False], ids=['norm_q', 'raw_q'])
@pytest.mark.parametrize('dh', [72, 96])
def test_qk_rope_plain_bf16_matches_pallas(dh, norm_q):
    """The rounding the CUDA kernel is held to, in bf16: LN statistics in
    fp32 rounded to bf16, the tables cast to bf16, each product and the sum
    rounded to bf16 (the plain version's eager bf16 ops) against the JAX
    package's Pallas kernel in interpret mode, at the XL and 3B head dims;
    k with an offset the LayerNorm removes."""
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops.fused_qk_rope import fused_qk_rope
    rng = _rng(21)
    q = _bf16(rng.standard_normal((B, N, H, dh)))
    k = _bf16(rng.standard_normal((B, N, H, dh)) * 2 + 1)
    ang = rng.uniform(0, 6.3, (B, N, dh)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    tq, tk = (_t(a.astype(np.float32)).bfloat16() for a in (q, k))
    oq, ok = K.qk_norm_rope_reference(tq, tk, _t(cos), _t(sin),
                                      norm_q=norm_q)
    with pltpu.force_tpu_interpret_mode():
        pq, pk = fused_qk_rope(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(cos), jnp.asarray(sin), 1e-6,
                               norm_q, True, N)
    for ours, pallas in ((oq, pq), (ok, pk)):
        assert ours.dtype == torch.bfloat16 and pallas.dtype == jnp.bfloat16
        ulps, share = _bf16_agreement(ours.float().numpy(),
                                      pallas.astype(jnp.float32))
        assert ulps <= BF16_ULPS and share <= BF16_SHARE, (ulps, share)


@pytest.mark.parametrize('layout,dh,want', [
    ('contiguous', 72, True), ('qkv column blocks', 72, True),
    ('qkv column blocks', 96, True), ('qkv column blocks', 32, True),
    ('contiguous', 48, False),               # no vector instantiation
    ('odd element start', 72, False),
    ('token stride 3C + 2', 72, False),
])
def test_qk_rope_vector_path_choice(layout, dh, want):
    """The wrapper's host-side choice of instantiation: the vector one for
    the configs' head dims with q, k, cos and sin on 16 bytes and token
    strides of whole 16-byte chunks (the qkv column blocks the Attention
    module hands over), the scalar one otherwise."""
    from fitv2_tpu_torch.kernels.fused_qk_rope import vector_path
    h = H
    c = h * dh
    for dtype in (torch.bfloat16, torch.float32):
        if layout == 'contiguous':
            q = k = torch.zeros(B, N, h, dh, dtype=dtype)
        elif layout == 'qkv column blocks':
            q, k, _ = torch.zeros(B, N, 3, h, dh, dtype=dtype).unbind(2)
        elif layout == 'odd element start':
            flat = torch.zeros(B, N, 3 * c + 1, dtype=dtype)
            q = flat[..., 1:1 + c].view(B, N, h, dh)
            k = flat[..., 1 + c:1 + 2 * c].view(B, N, h, dh)
        else:
            flat = torch.zeros(B, N, 3 * c + 2, dtype=dtype)
            q = flat[..., :c].view(B, N, h, dh)
            k = flat[..., c:2 * c].view(B, N, h, dh)
        cs = torch.zeros(B, N, dh)
        assert vector_path(q, k, cs, cs) == want, (layout, dtype)


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


@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('bounded', [False, True], ids=['online', 'bounded'])
def test_attention_plain_equals_torch_sdpa(bounded, masked):
    """The yardstick chip_smoke.py times beside the kernel,
    torch.nn.functional.scaled_dot_product_attention on (B, H, N, Dh) views
    with a boolean (B, 1, 1, N) key mask, computes the plain versions'
    function (fp32; every batch row keeps a valid key, where the -1e30 logit
    and SDPA's -inf agree)."""
    q, k, v = (_t(a) for a in _attn_inputs(9, normed=bounded))
    mask = _t(_mask()) if masked else None
    plain = K.attention_bounded_reference if bounded else K.attention_reference
    attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=attn_mask).transpose(1, 2)
    _close(plain(q, k, v, mask), sdpa)


# p rounded to bf16 before p @ v (the TPU kernels, the CUDA kernel) against
# the plain version's fp32 p, on bf16 inputs: the card tests' tolerance
ATOL_BF16_ATTN = 2e-2


@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('bounded', [False, True], ids=['online', 'bounded'])
def test_attention_bf16_pallas_within_card_tolerance(bounded, masked):
    """In bf16 the JAX package's own kernels (flash_attention's online
    softmax in interpret mode, attention_core's bounded one) round p to
    bf16 before p @ v, and the first also scales q in bf16; they stay within
    the 2e-2 absolute tolerance that the card tests hold the CUDA kernel to
    against the same plain version. So that tolerance is the reference's
    own rounding, not a looser bar for the port."""
    import ml_dtypes
    from jax.experimental.pallas import tpu as pltpu
    from fitv2_tpu.ops import attention_core as ac
    from fitv2_tpu.ops import flash_attention as fa
    q, k, v = (np.asarray(a, ml_dtypes.bfloat16)
               for a in _attn_inputs(10, normed=True))
    mask = _mask() if masked else None
    tq, tk, tv = (_t(a.astype(np.float32)).bfloat16() for a in (q, k, v))
    plain = K.attention_bounded_reference if bounded else K.attention_reference
    ours = plain(tq, tk, tv, None if mask is None else _t(mask))
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    if bounded:
        old = ac._INTERPRET
        ac._INTERPRET = True
        try:
            pallas = ac.attention_core(*(x.transpose(0, 2, 1, 3)
                                         for x in (jq, jk, jv)), jm)
        finally:
            ac._INTERPRET = old
        pallas = pallas.transpose(0, 2, 1, 3)
    else:
        with pltpu.force_tpu_interpret_mode():
            pallas = fa._flash_forward(jq, jk, jv, jm, N, N)
    assert pallas.dtype == jnp.bfloat16
    pallas = np.asarray(pallas.astype(jnp.float32))
    err = np.abs(ours.float().numpy() - pallas).max()
    assert 0 < err <= ATOL_BF16_ATTN, err


@pytest.mark.parametrize('layout,fault', [
    ('contiguous', None), ('qkv column block', None),
    ('token stride 3C + 2', 'stride'), ('2 elements off', 'pointer')])
def test_bf16_attention_row_alignment_check(layout, fault):
    """The bf16 kernel copies 16-byte row chunks: the wrapper's check passes
    the layouts the model hands over (contiguous q/k from K2, v as a column
    block of the qkv projection) and refuses a token stride or a start off
    16 bytes."""
    from fitv2_tpu_torch.kernels.flash_attention import _check_aligned
    h, dh = H, DH
    if layout == 'contiguous':
        x = torch.zeros(B, N, h, dh, dtype=torch.bfloat16)
    elif layout == 'qkv column block':
        x = torch.zeros(B, N, 3, h, dh, dtype=torch.bfloat16).unbind(2)[2]
    elif fault == 'stride':
        x = torch.zeros(B, N, 3 * h * dh + 2, dtype=torch.bfloat16)[
            ..., :h * dh].view(B, N, h, dh)
    else:
        x = torch.zeros(B, N, 3 * h * dh, dtype=torch.bfloat16)[
            ..., 2:2 + h * dh].view(B, N, h, dh)
    if fault is None:
        _check_aligned('v', x)
    else:
        with pytest.raises(ValueError, match='v: .*aligned to 16 bytes'):
            _check_aligned('v', x)


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


_FAKE_NVCC = '''#!{python}
import os, sys
args = sys.argv[1:]
out = args[args.index('-o') + 1]
with open(os.environ['FAKE_NVCC_LOG'], 'a') as f:
    f.write(' '.join(args) + '\\n')
src = args[-1]
if os.path.basename(src) == os.environ.get('FAKE_NVCC_FAIL'):
    sys.exit(2)
print('ptxas info : compiled ' + os.path.basename(src) if '-c' in args
      else 'linked')
open(out, 'w').close()
'''


@pytest.mark.parametrize('fail', [None, 'int8_gemm.cu'], ids=['ok', 'fails'])
def test_build_compiles_each_source_then_links(monkeypatch, tmp_path, fail):
    """The build runs one nvcc per source and then one link, with a fake
    nvcc (this machine has none): the library appears under its hash only
    when every compile succeeded, and a failure names its source."""
    import sys
    bindir = tmp_path / 'bin'
    bindir.mkdir()
    fake = bindir / 'nvcc'
    fake.write_text(_FAKE_NVCC.replace('{python}', sys.executable))
    fake.chmod(0o755)
    log = tmp_path / 'nvcc.log'
    monkeypatch.setenv('PATH', str(bindir))
    monkeypatch.setenv('FAKE_NVCC_LOG', str(log))
    if fail:
        monkeypatch.setenv('FAKE_NVCC_FAIL', fail)
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path / 'build')
    names = sorted(p.name for p in _build.sources())
    if fail:
        with pytest.raises(RuntimeError, match=f'nvcc failed: {fail}'):
            _build.build()
        assert not _build.library_path().exists()
    else:
        path, report = _build.build()
        assert path == _build.library_path() and path.exists()
        assert sorted(ln.split()[-1] for ln in report.splitlines()
                      if 'compiled' in ln) == names
        assert _build.build() == (path, '')  # built once, then reused
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if ' -c ' in c]
    assert sorted(c.split()[-1].rsplit('/', 1)[-1] for c in compiles) == names
    assert len(calls) == len(names) + (0 if fail else 1)  # + the link
    # no object or temporary file is left beside the library
    left = [p.name for p in (tmp_path / 'build').rglob('*') if p.is_file()]
    assert left == ([] if fail else [_build.LIB_NAME])
