"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version at ragged shapes and every head dim the attention kernel is built
for, in bf16 and fp32, and a small FiT forward and sampler on CUDA against
the same model on the CPU.

Every test needs a CUDA card of compute capability 9.0 and ``nvcc``; where
there is none (as on a CPU-only machine) each test skips. The file imports
no JAX, so on the card's machine it runs without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 kernel vs plain, 1e-5 of the output's largest magnitude
(the same math summed in another order); bf16, 2 bf16 ulps of that
magnitude (both sides compute in fp32 and round once, so an fp32 value that
differs in its last bits may round to the neighbouring bf16).
"""

import math

import pytest
import torch

from fitv2_tpu_torch import kernels as K
from fitv2_tpu_torch.kernels.flash_attention import HEAD_DIMS

pytestmark = pytest.mark.cuda

TOL_FP32_REL = 1e-5
TOL_BF16_ULPS = 2
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
@pytest.mark.parametrize('b,n,d', [(3, 77, 1152), (2, 5, 144), (1, 9, 2304)])
def test_adaln_kernel_matches_plain(dev, dtype, b, n, d):
    g = _gen(dev, 0)
    x = (torch.randn(b, n, d, device=dev, generator=g) * 2 + 3).to(dtype)
    mod = (0.5 * torch.randn(b, 6 * d, device=dev, generator=g)).to(dtype)
    shift, scale = mod.chunk(6, dim=-1)[3:5]  # column chunks, row stride 6D
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
@pytest.mark.parametrize('dh', HEAD_DIMS)
@pytest.mark.parametrize('bounded', [True, False], ids=['bounded', 'online'])
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
def test_attention_kernel_matches_plain(dev, dtype, dh, bounded, masked):
    """N = 200 leaves a ragged last tile of queries and keys; the mask has a
    full row, a partial one and an empty one (every key padded)."""
    g = _gen(dev, 2)
    b, n, h = 3, 200, 2
    qkv = torch.randn(b, n, 3, h, dh, device=dev, generator=g)
    q, k, v = qkv.unbind(2)
    if bounded:  # the bounded-logit contract: no-affine LN on q and k
        q, k = (torch.nn.functional.layer_norm(t, (dh,), eps=1e-6)
                for t in (q, k))
    else:  # large logits exercise the running max
        q, k = 2 * q, 2 * k
    q, k, v = (t.to(dtype) for t in (q, k, v))
    mask = None
    if masked:
        mask = torch.zeros(b, n, device=dev)
        mask[0] = 1.0
        mask[1, :37] = 1.0
    before = K.flash_masked_attention.launches
    out = K.masked_attention(q, k, v, mask, bounded_logits=bounded)
    assert K.flash_masked_attention.launches == before + 1
    plain = K.attention_bounded_reference if bounded else K.attention_reference
    _assert_close(out, plain(q, k, v, mask))


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


def _small_fit():
    """The small FiTv2 with its zero-init leaves perturbed (an untrained FiT
    outputs exactly 0, which would make the comparison vacuous)."""
    from fitv2_tpu_torch.models import FiT
    torch.manual_seed(0)
    model = FiT(**SMALL)
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
        [2 * depth + 1, depth, depth]
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
        [steps * (2 * depth + 1), steps * depth, steps * depth]
    # the two-level test decoder upsamples the 8x8 latents once
    assert images.dtype == torch.uint8 and images.shape == (b, 16, 16, 3)
    assert images.device.type == 'cuda'
