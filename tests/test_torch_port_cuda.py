"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version at ragged shapes and every head dim the attention kernels are built
for, in bf16 and fp32, and small FiT forwards (dense, int8, fused
attention) and a sampler on CUDA against the same model on the CPU; the
kernels' autograd Functions (K1-K5) against autograd of the plain
versions, and an XL-width FiT's gradients on CUDA against the CPU's.

Every test needs a CUDA card of compute capability 9.0 and ``nvcc``; where
there is none (as on a CPU-only machine) each test skips. The file imports
no JAX, so on the card's machine it runs without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 kernel vs plain, 1e-5 of the output's largest magnitude
(the same math summed in another order); bf16, 2 bf16 ulps of that
magnitude (both sides compute in fp32 and round once, so an fp32 value that
differs in its last bits may round to the neighbouring bf16). The int8
GEMMs' accumulators are exact: K6 applies the same unfused epilogue as its
plain version (f32 multiply, then f32 add, then one rounding to the output
dtype), so it must equal it bit for bit, and the SwiGLU requantization may
flip a rounding tie (at most 0.1% of the elements, by one level). The
attention kernels (K3/K4 and the fused one) round p to bf16 before p @ v,
as the TPU kernels do, while the plain versions keep it in fp32: 2e-2
absolute in bf16.
"""

import copy
import math

import pytest
import torch

from fitv2_tpu_torch import kernels as K
from fitv2_tpu_torch.kernels.flash_attention import HEAD_DIMS
from fitv2_tpu_torch.models import remat as remat_lib

pytestmark = pytest.mark.cuda

TOL_FP32_REL = 1e-5
TOL_BF16_ULPS = 2
TOL_BF16_ATTN = 2e-2  # absolute: p rounded to bf16 before p @ v
SMALL = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=144,
             depth=2, num_heads=2, learn_sigma=False, use_sit=True,
             use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
             adaln_type='lora', adaln_lora_dim=36, num_classes=10,
             max_cached_len=16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (Hopper, sm_90a) and nvcc')
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip('the kernels are built for sm_90a (Hopper) only')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _assert_close(out, ref):
    """Kernel output against the plain version, tolerance by dtype."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    if out.dtype == torch.float32:
        assert err <= TOL_FP32_REL * top, (err, top)
    else:
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert err <= TOL_BF16_ULPS * ulp, (err, top)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('b,n,d', [(3, 77, 1152), (2, 5, 144), (1, 9, 2304),
                                   (3, 77, 128), (3, 77, 384),
                                   (3, 77, 2304)])
def test_adaln_kernel_matches_plain(dev, dtype, b, n, d):
    """Every width in configs/ (128, 384, 1152, 2304: the vector
    instantiation) and 144 (the scalar one); 3 x 77 rows is no multiple of
    a block's 4 rows. A large common offset: the moments are two-pass."""
    from fitv2_tpu_torch.kernels.fused_adaln import VECTOR_WIDTHS, vector_path
    g = _gen(dev, 0)
    x = (torch.randn(b, n, d, device=dev, generator=g) * 2 + 3).to(dtype)
    mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=g)).to(dtype)
    shift, scale = mod.chunk(6, dim=-1)[3:5]  # column chunks, row stride 6D
    assert vector_path(x, shift, scale) == (d in VECTOR_WIDTHS)
    before = K.fused_adaln_norm.launches
    out = K.adaln_norm(x, shift, scale)
    assert K.fused_adaln_norm.launches == before + 1
    _assert_close(out, K.adaln_norm_reference(x, shift, scale))


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('view', ['modulation', 'x'])
@pytest.mark.parametrize('d', [1152, 384])
def test_adaln_kernel_misaligned_view_takes_scalar_path(dev, dtype, view, d):
    """shift/scale as column slices starting at an odd element (row stride
    6D + 1), or x a contiguous view one element into its storage: off the
    vector instantiation's 4-element boundary, so the wrapper picks the
    scalar one, which launches once and agrees with the plain version."""
    from fitv2_tpu_torch.kernels.fused_adaln import vector_path
    g = _gen(dev, 10)
    b, n = 3, 77
    if view == 'x':
        flat = torch.randn(b * n * d + 1, device=dev, generator=g) * 2 + 3
        x = flat.to(dtype)[1:].view(b, n, d)
        mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=g)).to(dtype)
        shift, scale = mod[:, :d], mod[:, d:2 * d]
    else:
        x = (torch.randn(b, n, d, device=dev, generator=g) * 2 + 3).to(dtype)
        mod = (0.5 * torch.randn(b, 6 * d + 1, device=dev, generator=g)
               ).to(dtype)
        shift, scale = mod[:, 1:1 + d], mod[:, 1 + d:1 + 2 * d]
    assert x.is_contiguous() and not vector_path(x, shift, scale)
    before = K.fused_adaln_norm.launches
    out = K.adaln_norm(x, shift, scale)
    assert K.fused_adaln_norm.launches == before + 1
    _assert_close(out, K.adaln_norm_reference(x, shift, scale))


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('dh', [32, 64, 72, 96, 128])
@pytest.mark.parametrize('norm_q,norm_k', [(True, True), (False, True)])
def test_qk_rope_kernel_matches_plain(dev, dtype, dh, norm_q, norm_k):
    g = _gen(dev, 1)
    b, n, h = 2, 37, 3
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g).to(dtype)
    q, k, _ = qkv.unbind(2)  # token stride 3C, as the Attention module has
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = K.fused_qk_rope.launches
    out = K.qk_norm_rope(q, k, cos, sin, norm_q=norm_q, norm_k=norm_k)
    assert K.fused_qk_rope.launches == before + 1
    ref = K.qk_norm_rope_reference(q, k, cos, sin, norm_q=norm_q,
                                   norm_k=norm_k)
    for o, r in zip(out, ref):
        _assert_close(o, r)


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('dh,h', [(32, 4), (64, 6), (72, 16), (96, 24),
                                  (128, 16)])
@pytest.mark.parametrize('norm_q', [True, False], ids=['norm_q', 'raw_q'])
def test_qk_rope_kernel_config_heads(dev, dtype, dh, h, norm_q):
    """The configs' (Dh, H) pairs (small_cifar 32 x 4, bfm 64 x 6, XL
    72 x 16, 3B 96 x 24) and Dh 128, over 3 x 77 tokens: 2H rows a token,
    so a warp's 32 rows hold several tokens, exactly one, or straddle two,
    and the last block is ragged. k carries an offset the LayerNorm
    removes; with norm_q False, q passes to the rotation as it is."""
    from fitv2_tpu_torch.kernels.fused_qk_rope import vector_path
    g = _gen(dev, 11)
    b, n = 3, 77
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g)
    qkv[:, :, 1] = qkv[:, :, 1] * 2 + 1
    q, k, _ = qkv.to(dtype).unbind(2)
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    assert vector_path(q, k, cos, sin)
    before = K.fused_qk_rope.launches
    out = K.qk_norm_rope(q, k, cos, sin, norm_q=norm_q)
    assert K.fused_qk_rope.launches == before + 1
    ref = K.qk_norm_rope_reference(q, k, cos, sin, norm_q=norm_q)
    for o, r in zip(out, ref):
        _assert_close(o, r)


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('fault', ['odd element start', 'head dim 48'])
def test_qk_rope_kernel_scalar_path(dev, dtype, fault):
    """q and k as column slices of a (B, N, 3C + 1) projection starting at
    an odd element, or a head dim without a vector instantiation: the
    wrapper picks the scalar instantiation, which launches once and agrees
    with the plain version."""
    from fitv2_tpu_torch.kernels.fused_qk_rope import vector_path
    g = _gen(dev, 12)
    b, n, h = 3, 77, 16
    dh = 48 if fault == 'head dim 48' else 72
    c = h * dh
    flat = torch.randn(b, n, 3 * c + 1, device=dev, generator=g).to(dtype)
    if fault == 'odd element start':
        q = flat[..., 1:1 + c].view(b, n, h, dh)
        k = flat[..., 1 + c:1 + 2 * c].view(b, n, h, dh)
    else:
        q, k = (flat[..., i * c:(i + 1) * c].view(b, n, h, dh)
                for i in (0, 1))
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    assert not vector_path(q, k, cos, sin)
    before = K.fused_qk_rope.launches
    out = K.qk_norm_rope(q, k, cos, sin)
    assert K.fused_qk_rope.launches == before + 1
    for o, r in zip(out, K.qk_norm_rope_reference(q, k, cos, sin)):
        _assert_close(o, r)


def _attention_rounding_p(q, k, v, mask, bounded):
    """The bf16 kernel's arithmetic in fp32 on the card: logits in the log2
    domain (masked keys at -1e30), keys in tiles of 64 with the running max
    and the rescale of l and o once a tile (no max in bounded mode), p
    rounded to bf16 before p @ v, l summed from the unrounded p."""
    dh = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # B H N Dh
    s = qf @ kf.transpose(-1, -2) * (dh ** -0.5 * math.log2(math.e))
    if mask is not None:
        s = s.masked_fill((mask <= 0)[:, None, None, :], -1e30)
    m = torch.full_like(s[..., :1], -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for k0 in range(0, s.shape[-1], 64):
        st = s[..., k0:k0 + 64]
        if bounded:
            p = torch.exp2(st)
        else:
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            m, l, o = m_new, l * alpha, o * alpha
            p = torch.exp2(st - m_new)
        l = l + p.sum(-1, keepdim=True)
        o = o + p.bfloat16().float() @ vf[..., k0:k0 + 64, :]
    return (o / l.clamp(min=1e-20)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('dh', HEAD_DIMS)
@pytest.mark.parametrize('bounded', [True, False], ids=['bounded', 'online'])
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('n', [1, 65, 200, 256, 1024])
def test_attention_kernel_matches_plain(dev, dtype, dh, bounded, masked, n):
    """N = 1, 65 and 200 leave a ragged last tile of queries and keys, 256
    is the XL context and 1024 the HR one. v (and in the online case q and
    k) are column blocks of a (B, N, 3, H, Dh) qkv, token stride 3C, as the
    model hands them over. The mask has a full row, a partial one and an
    empty one (every key padded: the online softmax averages the n values,
    the bounded one gives 0).

    bf16 tolerance, 2e-2 absolute: the kernel rounds p to bf16 before
    p @ v, as both TPU kernels do (flash_attention.py, attention_core.py),
    while the plain version keeps p in fp32; the attention tolerance of
    chip_smoke.py and of the fused attention below. So that a fault smaller
    than that (a key tile dropped or counted twice at large n) cannot hide
    in it, the bf16 kernel is also held to 2 bf16 ulps of the output's
    largest magnitude against _attention_rounding_p, which rounds p where
    the kernel does: what is left is fp32 summation order and the rare p
    that ex2.approx rounds to the neighbouring bf16."""
    g = _gen(dev, 2)
    b, h = 3, 2
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g)
    if bounded:  # the bounded-logit contract: no-affine LN on q and k
        qkv[:, :, :2] = torch.nn.functional.layer_norm(qkv[:, :, :2], (dh,),
                                                       eps=1e-6)
    else:  # large logits exercise the running max
        qkv[:, :, :2] *= 2
    q, k, v = qkv.to(dtype).unbind(2)
    assert not v.is_contiguous()
    mask = None
    if masked:
        mask = torch.zeros(b, n, device=dev)
        mask[0] = 1.0
        mask[1, :(n + 4) // 5] = 1.0
    before = K.flash_masked_attention.launches
    out = K.masked_attention(q, k, v, mask, bounded_logits=bounded)
    assert K.flash_masked_attention.launches == before + 1
    plain = K.attention_bounded_reference if bounded else K.attention_reference
    ref = plain(q, k, v, mask)
    if dtype == torch.float32:
        _assert_close(out, ref)
    else:
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.isfinite(out).all()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL_BF16_ATTN, err
        _assert_close(out, _attention_rounding_p(q, k, v, mask, bounded))


@pytest.mark.parametrize('which', ['q', 'k', 'v'])
@pytest.mark.parametrize('fault', ['stride', 'pointer'])
def test_attention_wrapper_refuses_misaligned_bf16_rows(dev, which, fault):
    """The bf16 kernel copies 16-byte row chunks: a token stride that is not
    a multiple of 8 elements, or a pointer off 16 bytes, raises before any
    launch. fp32 (the scalar kernel) takes the same layout."""
    b, n, h, dh = 2, 64, 2, 72
    src = torch.randn(b, n, h, dh, device=dev, generator=_gen(dev, 3))

    def operands(dtype):
        # 2 elements off: 4 bytes in bf16, 8 in fp32
        if fault == 'stride':  # token stride 3C + 2 elements
            base = torch.zeros(b, n, 3 * h * dh + 2, device=dev, dtype=dtype)
            bad = base[..., :h * dh]
        else:  # 2 elements past an aligned start
            base = torch.zeros(b, n, 3 * h * dh, device=dev, dtype=dtype)
            bad = base[..., 2:2 + h * dh]
        bad = bad.view(b, n, h, dh)
        bad.copy_(src)
        return [bad if x == which else src.to(dtype) for x in 'qkv']

    before = K.flash_masked_attention.launches
    with pytest.raises(ValueError, match=f'{which}: .*aligned to 16 bytes'):
        K.flash_masked_attention(*operands(torch.bfloat16))
    assert K.flash_masked_attention.launches == before
    q, k, v = operands(torch.float32)
    _assert_close(K.flash_masked_attention(q, k, v),
                  K.attention_reference(q, k, v))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 2, 48, device=dev)  # head dim 48: not instantiated
    with pytest.raises(ValueError, match='head dim'):
        K.flash_masked_attention(q, q, q)
    x = torch.zeros(1, 4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match='float32 or all bfloat16'):
        K.fused_adaln_norm(x, x[:, 0], x[:, 0])
    y = torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(ValueError, match='different devices'):
        K.fused_adaln_norm(y, y[:, 0].cpu(), y[:, 0])


def _int8_operands(dev, m, k, n, seed):
    g = _gen(dev, seed)
    xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8,
                       generator=g)
    wq = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8,
                       generator=g)
    scale = torch.rand(n, device=dev, generator=g) * 1e-4 + 1e-5
    bias = torch.randn(n, device=dev, generator=g)
    return xq, wq, scale, bias


def _assert_int8_gemm_bias_exact(xq, wq, scale, bias, out_dtype):
    """K6 against its plain version: equal bit for bit (an exact s32
    accumulator and the same unfused f32 epilogue on both sides)."""
    (m, k), n = xq.shape, wq.shape[0]
    before = K.int8_gemm_bias.launches
    out = K.dequant_gemm(xq, wq, scale, bias, out_dtype)
    assert K.int8_gemm_bias.launches == before + 1
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        ref = K.int8_gemm_bias_reference(xq, wq, scale, bias, out_dtype)
    else:  # torch._int_mm on CUDA refuses the shape: the same plain
        # version on the CPU (IEEE f32 ops, the same rounding)
        ref = K.int8_gemm_bias_reference(
            xq.cpu(), wq.cpu(), scale.cpu(),
            None if bias is None else bias.cpu(), out_dtype).to(out.device)
    assert out.dtype == out_dtype and out.shape == (m, n)
    assert torch.isfinite(out).all()
    diff = (out.float() - ref.float()).abs()
    assert torch.equal(out, ref), (diff.max().item(), diff.nonzero()[:4])


@pytest.mark.parametrize('out_dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('with_bias', [True, False], ids=['bias', 'no_bias'])
@pytest.mark.parametrize('m,k,n', [
    (2048, 1152, 1152), (2048, 3072, 1152), (4096, 1152, 3456),
    (4096, 3072, 1152), (400, 1152, 1160), (300, 1168, 1160), (1, 16, 8),
    (129, 3072, 145), (17, 32, 24)])
def test_int8_gemm_bias_kernel_matches_plain(dev, out_dtype, with_bias, m, k,
                                             n):
    """The int8 path's sites at M = 2048 and 4096 (qkv, proj, fc2), and
    ragged shapes: M = 400, 300, 129 and N = 1160, 145 past a 128 x 144
    tile by a few rows and columns, K = 1168 not a multiple of the 128-byte
    box, odd N, and a single row."""
    xq, wq, scale, bias = _int8_operands(dev, m, k, n, seed=5)
    _assert_int8_gemm_bias_exact(xq, wq, scale, bias if with_bias else None,
                                 out_dtype)


@pytest.mark.parametrize('out_dtype', DTYPES, ids=['fp32', 'bf16'])
def test_int8_gemm_bias_kernel_saturated(dev, out_dtype):
    """Every operand +-127 at K = 3072: |acc| up to 127^2 * 3072 > 2^24, so
    its f32 conversion rounds; both sides round the same s32 the same way."""
    m, k, n = 256, 3072, 288
    g = _gen(dev, 9)

    def pm127(*shape):
        bits = torch.randint(0, 2, shape, device=dev, generator=g,
                             dtype=torch.int8)
        return 127 * (2 * bits - 1)

    xq = pm127(m, k)
    xq[:128] = 127  # rows of the extreme sums
    wq = pm127(n, k)
    wq[:8] = 127
    wq[8:16] = -127
    scale = torch.rand(n, device=dev, generator=g) * 1e-4 + 1e-5
    bias = torch.randn(n, device=dev, generator=g)
    acc = torch._int_mm(xq, wq.t())
    assert acc.abs().max().item() == 127 ** 2 * k
    _assert_int8_gemm_bias_exact(xq, wq, scale, bias, out_dtype)


def _assert_swiglu_close(xq, wq, scale, bias, osr):
    """K7 against its plain version: at most one level off, on at most 0.1%
    of the s8 outputs (a rounding tie flipped by a 1-ulp sigmoid)."""
    (m, k), h = xq.shape, wq.shape[0] // 2
    before = K.int8_gemm_swiglu_quant.launches
    out = K.swiglu_requant_gemm(xq, wq, scale, bias, osr)
    assert K.int8_gemm_swiglu_quant.launches == before + 1
    if m > 16:
        ref = K.int8_gemm_swiglu_quant_reference(xq, wq, scale, bias, osr)
    else:  # torch._int_mm on CUDA refuses M <= 16: the plain version on
        # the CPU
        ref = K.int8_gemm_swiglu_quant_reference(
            xq.cpu(), wq.cpu(), scale.cpu(), bias.cpu(), osr).to(out.device)
    assert out.dtype == torch.int8 and out.shape == (m, h)
    assert (ref != 0).float().mean() > 0.5  # not vacuous
    diff = (out.int() - ref.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3, (
        diff.max().item(), (diff > 0).float().mean().item())


@pytest.mark.parametrize('m,k,h', [
    (400, 1152, 1160), (4096, 1152, 3072), (2048, 1152, 3072), (33, 64, 40),
    (1, 1152, 3072), (17, 1152, 3072), (129, 1152, 3072)])
def test_int8_gemm_swiglu_kernel_matches_plain(dev, m, k, h):
    """The int8 path's fc1 at M = 4096 (CFG batch) and 2048 (conditional
    only); ragged M (1, 17, 129 rows: a tile row of 128 cut short or just
    passed); H = 1160 and 40, whose last tile of 96 output columns is
    ragged in both the gate and the value half; K = 64 shorter than the
    128-byte box."""
    xq, wq, scale, bias = _int8_operands(dev, m, k, 2 * h, seed=6)
    _assert_swiglu_close(xq, wq, scale * 0.3, 0.1 * bias, 20.0)


def test_int8_gemm_swiglu_kernel_saturated(dev):
    """Every operand +-127 at K = 3072: |acc| up to 127^2 * 3072 > 2^24, so
    its f32 conversion rounds (both sides round the same s32 the same
    way), and the requantization clips."""
    m, k, h = 256, 3072, 288
    g = _gen(dev, 13)

    def pm127(*shape):
        bits = torch.randint(0, 2, shape, device=dev, generator=g,
                             dtype=torch.int8)
        return 127 * (2 * bits - 1)

    xq = pm127(m, k)
    xq[:128] = 127  # rows of the extreme sums
    wq = pm127(2 * h, k)
    wq[:8] = 127
    wq[h:h + 8] = -127
    scale = torch.rand(2 * h, device=dev, generator=g) * 3e-6 + 1e-7
    bias = 0.1 * torch.randn(2 * h, device=dev, generator=g)
    assert torch._int_mm(xq, wq.t()).abs().max().item() == 127 ** 2 * k
    _assert_swiglu_close(xq, wq, scale, bias, 20.0)


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('n,masked', [(256, True), (256, False),
                                      (1024, True), (1024, False),
                                      (200, True), (37, False)])
@pytest.mark.parametrize('dh', HEAD_DIMS)
def test_fused_attention_kernel_matches_plain(dev, dtype, n, masked, dh):
    """N <= 256 keeps the normalised keys resident for both passes of the
    bf16 kernel (256 the XL context; 200 and 37 end in a ragged tile);
    N = 1024, the HR context, stages them again in each pass. The mask has
    a full row, a partial one and an empty one (every key padded: a
    uniform average)."""
    g = _gen(dev, 7)
    b, h = 3, 2
    qkv = torch.randn(b, n, 3 * h * dh, device=dev, generator=g).to(dtype)
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = None
    if masked:
        mask = torch.zeros(b, n, device=dev)
        mask[0] = 1.0
        mask[1, :n * 3 // 4] = 1.0
    before = K.fused_qkln_rope_attention.launches
    out = K.qkln_rope_attention(qkv, cos, sin, mask, h)
    assert K.fused_qkln_rope_attention.launches == before + 1
    ref = K.fused_qkln_rope_attention_reference(qkv, cos, sin, mask, h)
    assert out.dtype == dtype and out.shape == (b, n, h * dh)
    assert torch.isfinite(out).all()
    if masked:
        assert torch.all(out[mask == 0] == 0)
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * ref.float().abs().max().item(), err
    else:
        assert err <= TOL_BF16_ATTN, err


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xq, wq, scale, bias = _int8_operands(dev, 64, 32, 48, seed=8)
    launches = [w.launches for w in K.KERNEL_WRAPPERS]
    with pytest.raises(ValueError, match='on cpu'):
        K.int8_gemm_bias(xq, wq.cpu(), scale, bias)
    with pytest.raises(ValueError, match='CUDA'):
        K.int8_gemm_bias(xq.cpu(), wq, scale, bias)
    with pytest.raises(TypeError, match='int8'):
        K.int8_gemm_bias(xq.float(), wq, scale, bias)
    with pytest.raises(TypeError, match='float32'):
        K.int8_gemm_bias(xq, wq, scale.bfloat16(), bias)
    with pytest.raises(TypeError, match='out_dtype'):
        K.int8_gemm_bias(xq, wq, scale, bias, torch.float16)
    with pytest.raises(ValueError, match='K % 16'):
        K.int8_gemm_bias(xq[:, :24].contiguous(), wq[:, :24].contiguous(),
                         scale, bias)
    with pytest.raises(ValueError, match='K > 0'):
        K.int8_gemm_bias(xq[:, :0].contiguous(), wq[:, :0].contiguous(),
                         scale, bias)
    with pytest.raises(ValueError, match='on cpu'):
        K.int8_gemm_swiglu_quant(xq, wq, scale, bias.cpu(), 1.0)
    with pytest.raises(TypeError, match='int8'):
        K.int8_gemm_swiglu_quant(xq, wq.float(), scale, bias, 1.0)
    qkv = torch.zeros(1, 8, 3 * 144, device=dev)
    cs = torch.zeros(1, 8, 72, device=dev)
    with pytest.raises(ValueError, match='cos'):
        K.fused_qkln_rope_attention(qkv, cs.cpu(), cs, None, 2)
    with pytest.raises(TypeError, match='float32 or all bfloat16'):
        K.fused_qkln_rope_attention(qkv.half(), cs, cs, None, 2)
    with pytest.raises(ValueError, match='head dim'):
        K.fused_qkln_rope_attention(qkv, cs, cs, None, 3)
    assert [w.launches for w in K.KERNEL_WRAPPERS] == launches


def _small_fit(**overrides):
    """The small FiTv2 with its zero-init leaves perturbed (an untrained FiT
    outputs exactly 0, which would make the comparison vacuous)."""
    from fitv2_tpu_torch.models import FiT
    torch.manual_seed(0)
    model = FiT(**dict(SMALL, **overrides))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize('n_h,n_w', [(4, 4), (3, 4)], ids=['full', 'padded'])
def test_fit_forward_cuda_matches_cpu(dev, n_h, n_w):
    """fp32: the kernels on CUDA against the plain versions on the CPU,
    relative L2 within 1e-5 (fp32 GEMMs and reductions in another order)."""
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    model = _small_fit()
    b = 2
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, 16, 16, generator=g)
    t = torch.rand(b, generator=g)
    y = torch.tensor([3, 10])
    grid, mask, size = make_grid_mask_size(b, n_h, n_w, 16)
    mask = None if n_h * n_w == 16 else mask
    with torch.no_grad():
        want = model(x, t, y, grid, mask, size)
        counts = [w.launches for w in K.KERNEL_WRAPPERS]
        model_gpu = model.to(dev)
        got = model_gpu(x.to(dev), t.to(dev), y.to(dev), grid.to(dev),
                        None if mask is None else mask.to(dev),
                        size.to(dev)).cpu()
    depth = SMALL['depth']
    assert [w.launches - c for w, c in zip(K.KERNEL_WRAPPERS, counts)] == \
        [2 * depth + 1, depth, depth, 0, 0, 0]
    assert want.abs().max() > 0
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize('attn_impl', ['auto', 'fused'])
@pytest.mark.parametrize('n_h,n_w', [(8, 8), (6, 8)], ids=['full', 'padded'])
def test_small_cifar_fit_forward_cuda_matches_cpu(dev, attn_impl, n_h, n_w):
    """The model of configs/fitv2_small_cifar.yaml (hidden 128, 4 heads:
    Dh 32) in fp32, its zero-init leaves perturbed: the kernels on CUDA
    (K1, K2 and K4, or K1 and K5) against the plain versions on the CPU,
    relative L2 within 1e-5, on the full 8 x 8 grid and a padded 6 x 8."""
    import os
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.utils import config_to_model, load_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    net = load_config(os.path.join(repo, 'configs', 'fitv2_small_cifar.yaml')
                      )['diffusion']['network_config']
    torch.manual_seed(0)
    model = config_to_model(net, attn_impl=attn_impl)
    assert model.head_dim == 32
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    model.eval()
    b, n_ctx = 2, model.context_size
    x = torch.randn(b, n_ctx, 16, generator=g)
    t = torch.rand(b, generator=g)
    y = torch.tensor([3, 10])
    grid, mask, size = make_grid_mask_size(b, n_h, n_w, n_ctx)
    mask = None if n_h * n_w == n_ctx else mask
    with torch.no_grad():
        want = model(x, t, y, grid, mask, size)
        counts = [w.launches for w in K.KERNEL_WRAPPERS]
        got = model.to(dev)(x.to(dev), t.to(dev), y.to(dev), grid.to(dev),
                            None if mask is None else mask.to(dev),
                            size.to(dev)).cpu()
    depth = model.depth
    launched = [w.launches - c for w, c in zip(K.KERNEL_WRAPPERS, counts)]
    if attn_impl == 'fused':
        assert launched == [2 * depth + 1, 0, 0, depth, 0, 0]
    else:
        assert launched == [2 * depth + 1, depth, depth, 0, 0, 0]
    assert want.abs().max() > 0
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel


def test_sampler_with_vae_on_cuda(dev):
    """The bf16 serving path on a small model: CFG Euler steps, VAE decode,
    uint8, with every kernel launched on every step."""
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    from fitv2_tpu_torch.vae import AutoencoderKL
    torch.manual_seed(3)
    model = _small_fit().to(device=dev, dtype=torch.bfloat16)
    vae = AutoencoderKL((8, 16)).to(device=dev, dtype=torch.bfloat16).eval()
    steps, b = 3, 2
    fn = build_sampler(model, SamplingConfig(
        image_height=64, image_width=64, num_sampling_steps=steps,
        num_classes=10, per_device_batch=b), vae)
    counts = [w.launches for w in K.KERNEL_WRAPPERS]
    images = fn(torch.tensor([1, 10]),
                generator=torch.Generator().manual_seed(4))
    depth = SMALL['depth']
    assert [w.launches - c for w, c in zip(K.KERNEL_WRAPPERS, counts)] == \
        [steps * (2 * depth + 1), steps * depth, steps * depth, 0, 0, 0]
    # the two-level test decoder upsamples the 8x8 latents once
    assert images.dtype == torch.uint8 and images.shape == (b, 16, 16, 3)
    assert images.device.type == 'cuda'


@pytest.mark.parametrize('variant', ['int8', 'fused'])
def test_int8_and_fused_fit_forward_cuda_matches_cpu(dev, variant):
    """fp32, padded 3x4 bucket. int8: calibrated on the CPU, then moved;
    an int8 input may flip a rounding step where the fp32 upstream differs
    in its last bits, so relative L2 1e-3. fused: 1e-5, as the dense path."""
    from fitv2_tpu_torch.kernels.quant import (
        calibrate_quant_scales, prequantize_weights)
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    overrides = (dict(gemm_precision='int8') if variant == 'int8'
                 else dict(attn_impl='fused'))
    model = _small_fit(**overrides)
    b = 2
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, 16, 16, generator=g)
    t = torch.rand(b, generator=g)
    y = torch.tensor([3, 10])
    grid, mask, size = make_grid_mask_size(b, 3, 4, 16)
    args = (x, t, y, grid, mask, size)
    if variant == 'int8':
        calibrate_quant_scales(model, [args])
        prequantize_weights(model)
    with torch.no_grad():
        want = model(*args)
        counts = [w.launches for w in K.KERNEL_WRAPPERS]
        got = model.to(dev)(*(a.to(dev) for a in args)).cpu()
    depth = SMALL['depth']
    launched = [w.launches - c for w, c in zip(K.KERNEL_WRAPPERS, counts)]
    if variant == 'int8':
        assert launched == [2 * depth + 1, depth, depth, 0, 3 * depth, depth]
    else:
        assert launched == [2 * depth + 1, 0, 0, depth, 0, 0]
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= (1e-3 if variant == 'int8' else 1e-5), rel


# -- slice 5: the kernels' autograd Functions on the card ---------------------
# Gradients through the dispatchers (the kernel inside its Function) against
# autograd of the plain version on the same card inputs: fp32 within 1e-5
# of the largest |grad|; bf16 within 3e-2 of it (the plain version's
# autograd rounds its bf16 intermediates, the backward functions keep fp32
# to the end).
TOL_GRAD_BF16 = 3e-2


def _grads(fn, arrays, cots):
    leaves = [a.detach().clone().requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, leaves, cots)


def _assert_grads_close(ours, ref):
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert torch.isfinite(o).all()
        err = (o.float() - r.float()).abs().max().item()
        top = r.float().abs().max().item()
        tol = 1e-5 if o.dtype == torch.float32 else TOL_GRAD_BF16
        assert err <= tol * top, (err, top)


def _cots(dev, out, seed):
    g = _gen(dev, seed)
    outs = out if isinstance(out, tuple) else (out,)
    return [torch.randn(o.shape, device=dev, generator=g).to(o.dtype)
            for o in outs]


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('d', [1152, 144])
def test_adaln_function_gradients(dev, dtype, d):
    """K1 inside AdaLNNorm; shift and scale are column chunks of the adaLN
    output (row stride 6D): their gradients land in those columns."""
    g = _gen(dev, 20)
    x = (torch.randn(3, 77, d, device=dev, generator=g) * 2 + 3).to(dtype)
    mod = (0.5 * torch.randn(3, 6 * d, device=dev, generator=g)).to(dtype)

    def run(adaln):
        def fn(a, m):
            shift, scale = m.chunk(6, dim=-1)[3:5]
            return adaln(a, shift, scale)
        return fn
    before = K.fused_adaln_norm.launches
    cots = _cots(dev, K.adaln_norm_reference(x, *mod.chunk(6, -1)[3:5]), 21)
    ours = _grads(run(K.adaln_norm), [x, mod], cots)
    assert K.fused_adaln_norm.launches == before + 1
    _assert_grads_close(ours, _grads(run(K.adaln_norm_reference), [x, mod],
                                     cots))
    assert not ours[1][:, :3 * d].any() and not ours[1][:, 5 * d:].any()


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('dh', [32, 64, 72, 96, 128])
@pytest.mark.parametrize('norm_q', [True, False], ids=['norm_q', 'raw_q'])
def test_qk_rope_function_gradients(dev, dtype, dh, norm_q):
    """K2 inside QKNormRope on strided q/k views of a (B, N, 3, H, Dh)
    qkv: the gradient of v's columns stays 0."""
    g = _gen(dev, 22)
    qkv = torch.randn(2, 37, 3, 3, dh, device=dev, generator=g).to(dtype)
    ang = torch.rand(2, 37, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)

    def run(fn):
        def call(a):
            q, k, _ = a.unbind(2)
            return fn(q, k, cos, sin, norm_q=norm_q)
        return call
    before = K.fused_qk_rope.launches
    cots = _cots(dev, run(K.qk_norm_rope_reference)(qkv), 23)
    ours = _grads(run(K.qk_norm_rope), [qkv], cots)
    assert K.fused_qk_rope.launches == before + 1
    _assert_grads_close(ours, _grads(run(K.qk_norm_rope_reference), [qkv],
                                     cots))
    assert not ours[0][:, :, 2].any()


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('dh', HEAD_DIMS)
@pytest.mark.parametrize('bounded', [True, False], ids=['bounded', 'online'])
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
def test_attention_function_gradients(dev, dtype, dh, bounded, masked):
    """K3/K4 inside FlashMaskedAttention at N 200, every head dim built; the
    mask has a full row, a partial one and an empty one; q, k, v are
    column blocks of one qkv."""
    g = _gen(dev, 24)
    b, n, h = 3, 200, 2
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g)
    if bounded:
        qkv[:, :, :2] = torch.nn.functional.layer_norm(qkv[:, :, :2], (dh,),
                                                       eps=1e-6)
    qkv = qkv.to(dtype)
    mask = None
    if masked:
        mask = torch.zeros(b, n, device=dev)
        mask[0] = 1.0
        mask[1, :150] = 1.0
    plain = K.attention_bounded_reference if bounded else K.attention_reference

    def run(fn):
        return lambda a: fn(*a.unbind(2), mask)
    before = K.flash_masked_attention.launches
    cots = _cots(dev, run(plain)(qkv), 25)
    ours = _grads(lambda a: K.masked_attention(*a.unbind(2), mask,
                                               bounded_logits=bounded),
                  [qkv], cots)
    assert K.flash_masked_attention.launches == before + 1
    _assert_grads_close(ours, _grads(run(plain), [qkv], cots))


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('dh', HEAD_DIMS)
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
def test_fused_attention_function_gradients(dev, dtype, dh, masked):
    """K5 inside FusedQKLNRopeAttention: the gradient of the flat qkv, with
    a full, a partial and an empty mask row."""
    g = _gen(dev, 26)
    b, n, h = 3, 200, 2
    qkv = torch.randn(b, n, 3 * h * dh, device=dev, generator=g).to(dtype)
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = None
    if masked:
        mask = torch.zeros(b, n, device=dev)
        mask[0] = 1.0
        mask[1, :150] = 1.0
    before = K.fused_qkln_rope_attention.launches
    cots = _cots(dev, K.fused_qkln_rope_attention_reference(
        qkv, cos, sin, mask, h), 27)
    ours = _grads(lambda a: K.qkln_rope_attention(a, cos, sin, mask, h),
                  [qkv], cots)
    assert K.fused_qkln_rope_attention.launches == before + 1
    _assert_grads_close(ours, _grads(
        lambda a: K.fused_qkln_rope_attention_reference(a, cos, sin, mask, h),
        [qkv], cots))


def test_xl_width_fit_gives_every_parameter_a_gradient(dev):
    """FiTv2 at XL width (1152, 16 heads of 72), depth 2, fp32, one flow
    loss on a padded batch: on CUDA every parameter gets a gradient
    through the kernels, within 1e-4 relative L2 of the CPU's (the plain
    versions) for every parameter."""
    import copy
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.train import flow_loss
    torch.manual_seed(0)
    model = FiT(context_size=256, hidden_size=1152, depth=2, num_heads=16,
                learn_sigma=False, use_sit=True, use_swiglu=True,
                q_norm='layernorm', k_norm='layernorm', adaln_type='lora',
                adaln_lora_dim=288)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    grid, mask, size = make_grid_mask_size(2, 10, 20, 256)
    batch = dict(feature=torch.randn(2, 256, 16, generator=gen), grid=grid,
                 mask=mask, label=torch.tensor([3, 999]), size=size)
    draws = dict(t=torch.tensor([0.25, 0.8]),
                 x0=torch.randn(2, 256, 16, generator=gen),
                 drop_ids=torch.tensor([0, 1]))
    tr = create_transport()
    results = []
    for device in ('cpu', dev):
        m = copy.deepcopy(model).to(device)
        loss, _ = flow_loss(m, tr, {k: v.to(device) for k, v in batch.items()},
                            draws={k: v.to(device) for k, v in draws.items()})
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in
                                      m.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for name, g in g_gpu.items():
        assert g is not None, name
        ref = g_cpu[name]
        assert ref.norm() > 0, name
        rel = ((g.cpu() - ref).norm() / ref.norm()).item()
        assert rel <= 1e-4, (name, rel)


# -- FiTv1 (slice 6): K2 RoPE-only and K3 on a model path ---------------------

V1 = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=144,
          depth=2, num_heads=2, learn_sigma=True, use_swiglu=True,
          use_swiglu_large=True, adaln_type='normal', num_classes=10,
          max_cached_len=16)


def _small_fitv1():
    """configs/fit_xl.yaml's structure (learn_sigma, no q/k norm, adaLN
    'normal', SwiGLU-large) at V1's size, zero-init leaves perturbed."""
    from fitv2_tpu_torch.models import FiT
    torch.manual_seed(0)
    model = FiT(**V1)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


def _launched(before):
    return [w.launches - c for w, c in zip(K.KERNEL_WRAPPERS, before)]


@pytest.mark.parametrize('n_h,n_w', [(4, 4), (3, 4)], ids=['full', 'padded'])
def test_fitv1_forward_cuda_matches_cpu(dev, n_h, n_w):
    """fp32, FiTv1: K2 in its RoPE-only mode and K3 (online softmax) in
    every block, K4 never; relative L2 within 1e-5 of the CPU."""
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    model = _small_fitv1()
    b = 2
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, 16, 16, generator=g)
    t = torch.tensor([0.0, 1.0])  # FiTv1's clamped timesteps
    y = torch.tensor([3, 10])
    grid, mask, size = make_grid_mask_size(b, n_h, n_w, 16)
    mask = None if n_h * n_w == 16 else mask
    args = (x, t, y, grid, mask, size)
    with torch.no_grad():
        want = model(*args)
        counts = [w.launches for w in K.KERNEL_WRAPPERS]
        bounded = K.flash_masked_attention.bounded_launches
        got = model.to(dev)(*(None if a is None else a.to(dev)
                              for a in args)).cpu()
    depth = V1['depth']
    assert _launched(counts) == [2 * depth + 1, depth, depth, 0, 0, 0]
    assert K.flash_masked_attention.bounded_launches == bounded
    assert got.shape == (b, 16, 32) and want.abs().max() > 0
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize('mode', ['ddpm', 'ddim'])
def test_fitv1_diffusion_loop_cuda_matches_cpu(dev, mode):
    """10 respaced steps, CFG 1.5, fp32, the same seeded CPU generator on
    both devices (so the same z and per-step noise): relative L2 within
    1e-4 of the CPU, and every forward launches K1-K3."""
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    steps, b = 10, 2
    cfg = SamplingConfig(image_height=64, image_width=64,
                         num_sampling_steps=steps, num_classes=10,
                         per_device_batch=b, dtype=torch.float32,
                         sampler_mode=mode,
                         diffusion_config=dict(learn_sigma=True))
    model = _small_fitv1()
    labels = torch.tensor([1, 7])
    want = build_sampler(model, cfg)(
        labels, generator=torch.Generator().manual_seed(4))
    fn = build_sampler(model.to(dev), cfg)
    counts = [w.launches for w in K.KERNEL_WRAPPERS]
    got = fn(labels, generator=torch.Generator().manual_seed(4)).cpu()
    depth = V1['depth']
    assert _launched(counts) == [steps * (2 * depth + 1), steps * depth,
                                 steps * depth, 0, 0, 0]
    assert torch.isfinite(got).all() and got.shape == (b, 4, 8, 8)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
def test_k3_function_gradients_in_a_fitv1_block(dev, dtype):
    """One FiTv1 block at XL width (1152, 16 heads of 72; K2 RoPE-only, K3
    with 200 of 256 keys valid) forward and backward on CUDA against the
    same block on the CPU: the input's and every parameter's gradient
    within 1e-4 relative L2 in fp32, 3e-2 in bf16 (the plain versions'
    autograd rounds its bf16 intermediates)."""
    import copy
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    torch.manual_seed(0)
    model = FiT(context_size=256, hidden_size=1152, depth=1, num_heads=16,
                learn_sigma=True, use_swiglu=True, use_swiglu_large=True,
                adaln_type='normal')
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    grid, mask, size = make_grid_mask_size(2, 10, 20, 256)
    cos, sin = model.rope(grid, size)
    x = torch.randn(2, 256, 1152, generator=g)
    c = torch.randn(2, 1152, generator=g)
    cot = torch.randn(2, 256, 1152, generator=g)
    results = []
    for device in ('cpu', dev):
        block = copy.deepcopy(model.blocks[0]).to(device=device, dtype=dtype)
        xi = x.to(device=device, dtype=dtype, copy=True).requires_grad_(True)
        counts = [w.launches for w in K.KERNEL_WRAPPERS]
        bounded = K.flash_masked_attention.bounded_launches
        out = block(xi, c.to(device, dtype), mask.to(device),
                    cos.to(device), sin.to(device), 0.0)
        out.backward(cot.to(device, dtype))
        if device == dev:
            assert _launched(counts) == [2, 1, 1, 0, 0, 0]
            assert K.flash_masked_attention.bounded_launches == bounded
        results.append([xi.grad] + [p.grad for p in block.parameters()])
    tol = 1e-4 if dtype == torch.float32 else TOL_GRAD_BF16
    worst = 0.0
    for ref, ours in zip(*results):
        assert ours is not None and torch.isfinite(ours).all()
        rel = ((ours.cpu().float() - ref.float()).norm()
               / ref.float().norm()).item()
        assert rel <= tol, rel
        worst = max(worst, rel)
    print(f'FiTv1 block gradients {dtype}: worst relative L2 {worst:.3e} '
          f'<= {tol}')


# -- the LwD family (slice 7a) -------------------------------------------------

LWD = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=144,
           depth=4, num_heads=2, num_classes=10, number_of_perflow=2,
           n_patch_h=4, n_patch_w=4, adaln_type='lora', adaln_lora_dim=36,
           max_cached_len=16)
LWD_VARIANTS = {
    # REPA blocks, per-segment embedders and the shared trunk: K1, K2, K4
    'lwd': ('FiTLwD', dict(number_of_representation_blocks=2, repa_dim=24,
                           perlayer_embedder=True,
                           number_of_shared_blocks=1)),
    # the shared encoder (K1 with its (B, D) rows) and per-token decoders
    'shared': ('FiTLwDSharedEncSepDec', dict(
        number_of_representation_blocks=2, repa_dim=24)),
    # BFM-XL's blocks: 'normal' adaLN, RMSNorm q/k (K3), GELU MLPs
    'shared_rmsnorm': ('FiTLwDSharedEncSepDec', dict(
        number_of_representation_blocks=2, repa_dim=24, adaln_type='normal',
        q_norm='rmsnorm', k_norm='rmsnorm', use_swiglu=False)),
}


def _lwd_model(variant, **kw):
    """A small LwD-family model on the CPU in fp32, every parameter
    N(0, 0.05) from a seeded generator (adaLN-zero would make every output
    exactly 0)."""
    from fitv2_tpu_torch import models
    cls, extra = LWD_VARIANTS[variant]
    model = getattr(models, cls)(**{**LWD, **extra, **kw})
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize('n_h,n_w', [(4, 4), (3, 4)], ids=['full', 'padded'])
@pytest.mark.parametrize('variant', list(LWD_VARIANTS))
def test_lwd_forward_run_layer_cuda_matches_cpu(dev, variant, n_h, n_w):
    """fp32, each segment: the velocity and the REPA projection within 1e-5
    relative L2 of the CPU; RMSNorm q/k launch K3 and never K2 or K4."""
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    model = _lwd_model(variant)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 16, generator=g)
    t = torch.tensor([0.2, 0.7])
    y = torch.tensor([3, 10])
    grid, mask, size = make_grid_mask_size(2, n_h, n_w, 16)
    mask = None if n_h * n_w == 16 else mask
    gpu = copy.deepcopy(model).to(dev)
    for seg in range(2):
        args = (x, t, y, seg, grid, mask, size)
        with torch.no_grad():
            want = model.forward_run_layer(*args)
            counts = [w.launches for w in K.KERNEL_WRAPPERS]
            bounded = K.flash_masked_attention.bounded_launches
            got = gpu.forward_run_layer(*(
                a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args))
        launched = _launched(counts)
        assert launched[0] > 0 and launched[2] > 0
        if variant == 'shared_rmsnorm':
            assert launched[1] == 0
            assert K.flash_masked_attention.bounded_launches == bounded
        for o, w in zip(got, want):
            rel = ((o.cpu() - w).norm() / w.norm()).item()
            assert w.abs().max() > 0 and rel <= 1e-5, rel


@pytest.mark.parametrize('sampler', ['cfg', 'maruyama_sg', 'global_sg',
                                     'multiscale'])
def test_lwd_samplers_cuda_match_cpu(dev, sampler):
    """fp32 samplers on CUDA against the CPU on the same weights, noise and
    draws (a seeded CPU generator on both devices): relative L2 within
    1e-4."""
    from fitv2_tpu_torch.models import FiTLwD
    g = torch.Generator().manual_seed(5)
    y = torch.tensor([1, 7])
    if sampler == 'multiscale':
        model = _lwd_model('lwd', depth=4, number_of_perflow=4,
                           number_of_representation_blocks=0,
                           context_size=64, n_patch_h=8, n_patch_w=8)
        x = torch.randn(2, 4, 16, generator=g)

        def run(m, x, y):
            return m.sample_multiscale(
                x, y, 2, (1, 2), (1, 1, 2),
                generator=torch.Generator().manual_seed(3))
    else:
        model = _lwd_model('lwd' if sampler == 'cfg' else 'shared')
        x = torch.randn(2, 16, 16, generator=g)
        run = {
            'cfg': lambda m, x, y: m.sample_cfg(x, y, 1.5, 3),
            'maruyama_sg': lambda m, x, y: m.sample_maruyama_cfg(
                x, y, 1.4, 3, 0.1, 0.8, True,
                generator=torch.Generator().manual_seed(3)),
            'global_sg': lambda m, x, y: m.sample_maruyama_global_cfg(
                x, y, 1.5, 8, 0.2, 0.7, True,
                generator=torch.Generator().manual_seed(3)),
        }[sampler]
    assert isinstance(model, FiTLwD)
    want = run(model, x, y)
    got = run(copy.deepcopy(model).to(dev), x.to(dev), y.to(dev)).cpu()
    assert torch.isfinite(got).all() and got.shape == want.shape
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('n', [16, 64])
def test_kernels_at_the_multiscale_grids(dev, dtype, n):
    """K1, K2 and K4 at the multi-scale sampler's coarse grids (batch 8,
    XL widths, every token valid) against their plain versions."""
    g = _gen(dev, 7)
    x = (torch.randn(8, n, 1152, device=dev, generator=g) * 2 + 3).to(dtype)
    mod = (0.5 * torch.randn(8, 6 * 1152, device=dev, generator=g)
           ).to(dtype)
    shift, scale = mod.chunk(6, dim=-1)[:2]
    _assert_close(K.fused_adaln_norm(x, shift, scale),
                  K.adaln_norm_reference(x, shift, scale))
    q, k, v = torch.randn(8, n, 3, 16, 72, device=dev, generator=g
                          ).to(dtype).unbind(2)
    ang = torch.rand(8, n, 72, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    for o, r in zip(K.fused_qk_rope(q, k, cos, sin),
                    K.qk_norm_rope_reference(q, k, cos, sin)):
        _assert_close(o, r)
    qn, kn = K.qk_norm_rope_reference(q, k, cos, sin)
    out = K.flash_masked_attention(qn, kn, v, None, True)
    ref = K.attention_bounded_reference(qn, kn, v)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL_FP32_REL * ref.float().abs().max().item() \
        if dtype == torch.float32 else TOL_BF16_ATTN
    assert err <= tol, err


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
@pytest.mark.parametrize('n', [16, 64])
def test_lwd_train_functions_at_the_multiscale_grids(dev, dtype, n):
    """The multi-scale training tiers' grids (XL widths, batch 4, every
    token valid): K1, K2 and K4 inside their autograd Functions against
    autograd of the plain versions."""
    g = _gen(dev, 30)
    b, d, h, dh = 4, 1152, 16, 72
    x = (torch.randn(b, n, d, device=dev, generator=g) * 2 + 3).to(dtype)
    mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=g)).to(dtype)

    def adaln(fn):
        return lambda a, m: fn(a, *m.chunk(6, dim=-1)[:2])
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g).to(dtype)
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)

    def qk(fn):
        return lambda a: fn(*a.unbind(2)[:2], cos, sin)
    q, k, v = qkv.unbind(2)
    qkv_n = torch.stack([*K.qk_norm_rope_reference(q, k, cos, sin), v], 2)
    cases = [
        (K.fused_adaln_norm, adaln(K.adaln_norm),
         adaln(K.adaln_norm_reference), [x, mod]),
        (K.fused_qk_rope, qk(K.qk_norm_rope), qk(K.qk_norm_rope_reference),
         [qkv]),
        (K.flash_masked_attention,
         lambda a: K.masked_attention(*a.unbind(2), None,
                                      bounded_logits=True),
         lambda a: K.attention_bounded_reference(*a.unbind(2)), [qkv_n])]
    for i, (wrapper, function, plain, arrays) in enumerate(cases):
        before = wrapper.launches
        cots = _cots(dev, plain(*arrays), 31 + i)
        ours = _grads(function, arrays, cots)
        assert wrapper.launches == before + 1
        _assert_grads_close(ours, _grads(plain, arrays, cots))


def test_lwd_train_segment_update_cuda_matches_cpu(dev):
    """Two fp32 reflow segment updates (segment 1, then 0: Adam moves the
    untouched segment by its momentum) of a small FiTLwD with REPA blocks,
    per-segment embedders and a shared trunk, on CUDA against the CPU on
    the same weights, batch and draws: the losses, gradient norms and
    every updated master, moment and EMA within 1e-4 relative L2 (the
    slice's parity gate)."""
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.train import lwd_train_step as lts
    from fitv2_tpu_torch.train import train_step as tts
    model = _lwd_model('lwd')
    g = torch.Generator().manual_seed(9)
    grid, mask, size = make_grid_mask_size(2, 4, 4, 16)
    batch = dict(feature=torch.randn(2, 16, 16, generator=g), grid=grid,
                 mask=mask, label=torch.tensor([3, 8]), size=size,
                 repa_target=torch.randn(2, 16, 24, generator=g))
    draws = [dict(x0=torch.randn(2, 16, 16, generator=g),
                  r=torch.rand(2, generator=g),
                  drop_ids=torch.tensor(ids)) for ids in ([0, 1], [1, 0])]
    runs = {}
    for device in ('cpu', dev):
        m = copy.deepcopy(model).to(device)
        state = tts.create_train_state(m, tts.OptimizerConfig(
            learning_rate=1e-3))
        step = lts.make_lwd_train_step(m, ema_decay=0.9)
        before = [w.launches for w in K.KERNEL_WRAPPERS]
        metrics = [step(state, {k: v.to(device) for k, v in batch.items()},
                        seg, draws=d)[1] for seg, d in zip((1, 0), draws)]
        runs[str(device)] = (state, metrics, _launched(before))
    (cpu, m_cpu, _), (gpu, m_gpu, launched) = runs['cpu'], runs[str(dev)]
    assert launched[0] > 0 and launched[1] > 0 and launched[2] > 0
    for a, b in zip(m_gpu, m_cpu):
        for key in ('loss', 'grad_norm', 'flow_loss', 'proj_loss'):
            assert abs(a[key].item() - b[key].item()) <= 1e-5 * abs(
                b[key].item()), key
    for n, p in cpu.params.items():
        pairs = [(gpu.params[n], p), (gpu.ema_params[n], cpu.ema_params[n])]
        pairs += [(gpu.optimizer.state[gpu.params[n]][k],
                   cpu.optimizer.state[p][k]) for k in ('mu', 'nu')]
        for o, w in pairs:
            rel = ((o.cpu() - w).norm() / w.norm().clamp_min(1e-30)).item()
            assert rel <= 1e-4, (n, rel)


# -- slice 5c: the remat policies, the VAE encoder, CAME ----------------------

HR_WIDTHS = dict(context_size=1024, hidden_size=1152, depth=2, num_heads=16,
                 learn_sigma=False, use_sit=True, use_swiglu=True,
                 q_norm='layernorm', k_norm='layernorm', adaln_type='lora',
                 adaln_lora_dim=288, online_rope=True,
                 custom_freqs='ntk-aware', decouple=True, ori_max_pe_len=16,
                 max_cached_len=1024)


def _launch_counts():
    return {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}, \
        K.flash_masked_attention.bounded_launches


@pytest.mark.parametrize('policy', ['none', 'full', 'dots', 'dots_all',
                                    'dots_offload'])
def test_remat_policy_on_the_card(dev, policy):
    """FiTv2-HR-XL/2's widths (online decoupled NTK RoPE, N 1024: 1024 and
    800 tokens valid) at depth 2, fp32: one flow loss and backward under
    the policy on the card, every gradient within 1e-4 relative L2 of the
    CPU's without remat; the kernels launch inside the checkpointed region
    (K1 2 and K2, K4 1 a block again in the recompute). dots_offload's
    gradients equal dots' on the card bit for bit, and its saved products
    went to the host and came back."""
    import copy
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.models.grid_utils import make_grid
    from fitv2_tpu_torch.train import flow_loss
    torch.manual_seed(0)
    remat = policy != 'none'
    model = FiT(**HR_WIDTHS, use_checkpoint=remat,
                remat_policy=policy if remat else 'full')
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    grid = torch.zeros(2, 2, 1024, dtype=torch.int64)
    mask = torch.zeros(2, 1024)
    for i, (h, w) in enumerate(((32, 32), (20, 40))):
        grid[i, :, :h * w] = torch.from_numpy(make_grid(h, w))
        mask[i, :h * w] = 1.0
    batch = dict(feature=torch.randn(2, 1024, 16, generator=gen), grid=grid,
                 mask=mask, label=torch.tensor([3, 999]),
                 size=torch.tensor([[[32, 32]], [[20, 40]]]))
    draws = dict(t=torch.tensor([0.25, 0.8]),
                 x0=torch.randn(2, 1024, 16, generator=gen),
                 drop_ids=torch.tensor([0, 1]))
    tr = create_transport()
    results = []
    runs = [('cpu', policy), (dev, policy)]
    if policy == 'dots_offload':
        runs.append((dev, 'dots'))
    remat_lib.reset_counts()
    for device, run_policy in runs:
        m = copy.deepcopy(model).to(device)
        m.remat_policy = run_policy
        if device == 'cpu':
            m.use_checkpoint = False
        before, bounded = _launch_counts()
        loss, _ = flow_loss(m, tr, {k: v.to(device) for k, v in batch.items()},
                            draws={k: v.to(device) for k, v in draws.items()})
        loss.backward()
        after, bounded_after = _launch_counts()
        results.append(({n: p.grad for n, p in m.named_parameters()},
                        {k: after[k] - before[k] for k in after},
                        bounded_after - bounded))
    (g_cpu, _, _), (g_gpu, counts, bounded) = results[:2]
    d = 2
    if policy == 'dots_offload':
        g_dots, counts_dots, _ = results[2]
        assert counts == counts_dots
        for name, g in g_gpu.items():
            assert torch.equal(g, g_dots[name]), name
        moved = remat_lib.counts
        assert moved['d2h_copies'] == moved['h2d_copies'] == 6 * d
        assert moved['d2h_bytes'] == moved['h2d_bytes'] > 0
    assert counts['fused_adaln_norm'] == 2 * d + 1 + 2 * d * remat
    assert counts['fused_qk_rope'] == d * (1 + remat)
    assert counts['flash_masked_attention'] == bounded == d * (1 + remat)
    for name, g in g_gpu.items():
        ref = g_cpu[name]
        rel = ((g.cpu() - ref).norm() / ref.norm()).item()
        assert rel <= 1e-4, (name, rel)


def test_vae_encoder_cuda_matches_cpu(dev):
    """The SD-VAE encoder at its real widths (seeded), fp32 at 128 x 128:
    mean and logvar within 1e-4 relative L2 of the CPU's."""
    import copy
    from fitv2_tpu_torch.vae import AutoencoderKL
    torch.manual_seed(0)
    vae = AutoencoderKL().eval()
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)
                   ) * 2 - 1
    with torch.no_grad():
        ref = vae.encode(x)
        got = copy.deepcopy(vae).to(dev).encode(x.to(dev))
    for a, b in zip(got, ref):
        assert a.shape == (2, 16, 16, 4)
        rel = ((a.cpu() - b).norm() / b.norm()).item()
        assert rel <= 1e-4, rel


def test_came_update_cuda_matches_cpu(dev):
    """Three fp32 CAME updates over the JAX leaves of a FiT at XL width
    (depth 2, scanned blocks: stacked leaves) on the card against the CPU:
    every master and state tensor within 1e-5 relative L2."""
    import copy
    from fitv2_tpu_torch.ckpt import jax_leaves
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.train.came import CAME
    torch.manual_seed(0)
    model = FiT(context_size=256, hidden_size=1152, depth=2, num_heads=16,
                learn_sigma=False, use_swiglu=True, q_norm='layernorm',
                k_norm='layernorm', adaln_type='lora', adaln_lora_dim=288)
    gen = torch.Generator().manual_seed(2)
    grads = [[torch.randn(p.shape, generator=gen) for p in model.parameters()]
             for _ in range(3)]
    out = []
    for device in ('cpu', dev):
        m = copy.deepcopy(model).to(device)
        masters = dict(m.named_parameters())
        opt = CAME(masters, jax_leaves(m), lr=1e-3, weight_decay=0.01)
        for step in grads:
            for p, g in zip(masters.values(), step):
                p.grad = g.to(device)
            opt.step()
        out.append(([p.detach().cpu() for p in masters.values()],
                    [{k: v.cpu() for k, v in
                      opt.state[opt.leaf_params(leaf)[0]].items()}
                     for leaf in opt.leaves]))
    (p_cpu, s_cpu), (p_gpu, s_gpu) = out
    pairs = list(zip(p_gpu, p_cpu)) + [
        (a[k], b[k]) for a, b in zip(s_gpu, s_cpu) for k in b]
    for a, b in pairs:
        assert ((a - b).norm() / b.norm()).item() <= 1e-5


# -- slice 8a and item 20b: int8 LwD serving, int8 buckets, the GAN step ------

@pytest.mark.parametrize('site,k,n', [('qkv', 1152, 3456),
                                      ('proj', 1152, 1152),
                                      ('fc2', 3072, 1152), ('fc1', 1152, 0)])
@pytest.mark.parametrize('m', [4096, 2048])
def test_int8_gemms_at_the_lwd_xl_shapes(dev, site, k, n, m):
    """FiTLwD-XL's int8 serving GEMMs at M = 2B x 256 (CFG batch 8, 4):
    K6 at qkv, proj and fc2 bit for bit, K7 at fc1 (H 3072) within one
    level on at most 0.1% of its outputs."""
    if site == 'fc1':
        xq, wq, scale, bias = _int8_operands(dev, m, k, 2 * 3072, 40)
        _assert_swiglu_close(xq, wq, scale * 0.3, 0.1 * bias, 20.0)
    else:
        xq, wq, scale, bias = _int8_operands(dev, m, k, n, 41)
        _assert_int8_gemm_bias_exact(xq, wq, scale, bias, torch.bfloat16)


def test_int8_lwd_sampler_cuda_matches_cpu(dev):
    """A small int8 FiTLwD, calibrated through its forward (init_all) and
    prequantized on the CPU, samples with CFG on the card through K6 and
    K7 (3 and 1 a block a CFG eval) against the CPU's plain versions:
    relative L2 within 4e-3 (an int8 rounding flip, as in the CPU parity
    tests)."""
    from fitv2_tpu_torch.kernels.quant import (
        calibrate_quant_scales, prequantize_weights)
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    model = _lwd_model('lwd', gemm_precision='int8')
    g = torch.Generator().manual_seed(12)
    grid, _, size = make_grid_mask_size(8, 4, 4, 16)
    calibrate_quant_scales(model, [(
        torch.randn(8, 16, 16, generator=g), torch.full((8,), 0.5),
        torch.arange(8) % 10, grid, None, size, None,
        torch.Generator().manual_seed(13))])
    prequantize_weights(model)
    z, y = torch.randn(4, 16, 16, generator=g), torch.tensor([1, 4, 7, 2])
    want = model.sample_cfg(z, y, 1.5, 2)
    before = [w.launches for w in K.KERNEL_WRAPPERS]
    got = model.to(dev).sample_cfg(z.to(dev), y.to(dev), 1.5, 2).cpu()
    launched = dict(zip([w.__name__ for w in K.KERNEL_WRAPPERS],
                        _launched(before)))
    evals = model.number_of_perflow * 2
    blocks = model.layers_per_flow + model.number_of_shared_blocks
    assert launched['int8_gemm_bias'] == 3 * evals * blocks
    assert launched['int8_gemm_swiglu_quant'] == evals * blocks
    assert ((got - want).norm() / want.norm()).item() <= 4e-3


def test_int8_bucket_order_on_the_card(dev):
    """An int8 BucketedSampler on the card over buckets A (4 x 4 tokens)
    and B (6 x 6, dynntk) in the order A, B, A: the two A runs equal a
    sampler of A alone bit for bit, and each bucket keeps its own
    scales."""
    from fitv2_tpu_torch.kernels.quant import int8_layers
    from fitv2_tpu_torch.sample import BucketedSampler, SamplingConfig
    cfg = SamplingConfig(num_sampling_steps=3, num_classes=10,
                         per_device_batch=2, dtype=torch.float32)
    labels = torch.tensor([3, 8])

    def run(buckets, hw):
        return buckets.sample(labels, *hw, generator=torch.Generator(
        ).manual_seed(5)).cpu()
    a, b = (64, 64), (96, 96)
    model = _small_fit(gemm_precision='int8').to(dev)
    buckets = BucketedSampler(model, cfg, ori_max_pe_len=4)
    first = run(buckets, a)
    scales_a = [m.act_absmax for m in int8_layers(model).values()]
    other = run(buckets, b)
    scales_b = [m.act_absmax for m in int8_layers(model).values()]
    again = run(buckets, a)
    alone = run(BucketedSampler(_small_fit(gemm_precision='int8').to(dev),
                                cfg, ori_max_pe_len=4), a)
    assert torch.equal(first, again) and torch.equal(first, alone)
    assert any(not torch.equal(x, y) for x, y in zip(scales_a, scales_b))
    assert torch.isfinite(other).all() and other.shape[-2:] == (12, 12)


@pytest.mark.parametrize('dtype', DTYPES, ids=['fp32', 'bf16'])
def test_gan_functions_at_the_gan_shapes(dev, dtype):
    """cli/train_cifar_gan's student (D 384, 6 heads of 64, N 256, every
    token valid; batch 8): K1, K2 and K4 inside their autograd Functions
    against autograd of the plain versions."""
    g = _gen(dev, 50)
    b, n, d, h, dh = 8, 256, 384, 6, 64
    x = (torch.randn(b, n, d, device=dev, generator=g) * 2 + 3).to(dtype)
    mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=g)).to(dtype)
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g).to(dtype)
    ang = torch.rand(b, n, dh, device=dev, generator=g) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    q, k, v = qkv.unbind(2)
    qkv_n = torch.stack([*K.qk_norm_rope_reference(q, k, cos, sin), v], 2)
    cases = [
        (K.fused_adaln_norm,
         lambda a, m: K.adaln_norm(a, *m.chunk(6, dim=-1)[:2]),
         lambda a, m: K.adaln_norm_reference(a, *m.chunk(6, dim=-1)[:2]),
         [x, mod]),
        (K.fused_qk_rope, lambda a: K.qk_norm_rope(*a.unbind(2)[:2], cos, sin),
         lambda a: K.qk_norm_rope_reference(*a.unbind(2)[:2], cos, sin),
         [qkv]),
        (K.flash_masked_attention,
         lambda a: K.masked_attention(*a.unbind(2), None,
                                      bounded_logits=True),
         lambda a: K.attention_bounded_reference(*a.unbind(2)), [qkv_n])]
    for i, (wrapper, function, plain, arrays) in enumerate(cases):
        before = wrapper.launches
        cots = _cots(dev, plain(*arrays), 51 + i)
        ours = _grads(function, arrays, cots)
        assert wrapper.launches == before + 1
        _assert_grads_close(ours, _grads(plain, arrays, cots))


def test_gan_step_cuda_matches_cpu(dev):
    """One fp32 generator + discriminator step (a small FiTLwD student
    with 2 heads of 64, a PatchGAN with BatchNorm, the adversarial terms
    live) on the card against the CPU on the same weights, batch and draws:
    the losses within 1e-5 relative; every generator master, moment and
    EMA, and every discriminator parameter, running statistic and moment
    within 1e-4 relative L2."""
    from fitv2_tpu_torch.cli.train_cifar_gan import make_generator_loss
    from fitv2_tpu_torch.losses import (
        LPIPSWithDiscriminator2D, NLayerDiscriminator)
    from fitv2_tpu_torch.train import (
        OptimizerConfig, create_disc_state, create_train_state, disc_adam,
        make_gan_steps)
    from fitv2_tpu_torch.train.lwd_train_step import _segment_params
    student = _lwd_model('lwd', hidden_size=128, num_heads=2,
                         context_size=64, n_patch_h=8, n_patch_w=8,
                         in_channels=3)
    torch.manual_seed(3)
    disc0 = NLayerDiscriminator(input_nc=3, ndf=8, n_layers=2)
    g = torch.Generator().manual_seed(14)
    batch = dict(image=torch.rand(4, 16, 16, 3, generator=g) * 2 - 1,
                 label=torch.tensor([1, 4, 7, 9]))
    draws = dict(x0=torch.randn(4, 64, 12, generator=g),
                 r=torch.rand(4, generator=g),
                 drop_ids=torch.tensor([1, 0, 0, 1]))
    runs = {}
    for device in ('cpu', dev):
        model = copy.deepcopy(student).to(device).train()
        disc = copy.deepcopy(disc0).to(device).train()
        loss_fn = make_generator_loss(model, 4, device)
        state = create_train_state(model, OptimizerConfig(
            learning_rate=1e-3))
        dstate = create_disc_state(disc, lambda p: disc_adam(p, 1e-3))
        gen_step, disc_step = make_gan_steps(
            loss_fn, model, LPIPSWithDiscriminator2D(disc_weight=0.1),
            ema_decay=0.9, required=_segment_params(model))
        bd = {k: v.to(device) for k, v in batch.items()}
        dd = {k: v.to(device) for k, v in draws.items()}
        before = [w.launches for w in K.KERNEL_WRAPPERS]
        state, gm = gen_step(state, dstate, bd, None, dd, segment_idx=1)
        with torch.no_grad():
            _, fake = loss_fn(model, bd, None, dd, 1)
        dstate, dm = disc_step(dstate, bd['image'], fake, state.step)
        runs[str(device)] = (state, dstate, {**gm, **dm}, _launched(before))
    (cpu, dcpu, mcpu, _), (gpu, dgpu, mgpu, launched) = runs['cpu'], \
        runs[str(dev)]
    assert launched[0] > 0 and launched[1] > 0 and launched[2] > 0
    for key in ('loss', 'base_loss', 'g_loss', 'd_loss'):
        assert abs(mgpu[key].item() - mcpu[key].item()) <= 1e-5 * abs(
            mcpu[key].item()), key
    pairs = []
    for n, p in cpu.params.items():
        pairs += [(gpu.params[n], p), (gpu.ema_params[n], cpu.ema_params[n])]
        pairs += [(gpu.optimizer.state[gpu.params[n]][k],
                   cpu.optimizer.state[p][k]) for k in ('mu', 'nu')]
    dp = dict(dgpu.disc.named_parameters())
    for n, p in dcpu.disc.named_parameters():
        pairs += [(dp[n], p)] + [
            (dgpu.optimizer.state[dp[n]][k], dcpu.optimizer.state[p][k])
            for k in ('mu', 'nu')]
    sd = dgpu.disc.state_dict()
    pairs += [(sd[n], t) for n, t in dcpu.disc.state_dict().items()
              if 'running' in n]
    for o, w in pairs:
        if w.abs().max() > 0:
            rel = ((o.cpu() - w).norm() / w.norm()).item()
            assert rel <= 1e-4, rel
