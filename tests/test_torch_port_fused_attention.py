"""PyTorch port, the ``attn_impl='fused'`` path
(fitv2_tpu_torch.kernels.fused_attention): the plain version of the fused
qk-LN + RoPE + masked attention kernel against the Pallas kernel of
fitv2_tpu/ops/fused_attention.py in interpret mode and against its unfused
XLA chain ``_reference_chain``, and the fused FiT against the JAX FiT.

Tolerances: fp32, 2e-5 abs/rel (the same math summed in another order, as
tests/test_fused_attention.py bounds the kernel against the chain). bf16:
both sides round at the same places (LN output, each rotation product and
sum, p, the output), so a difference is a single bf16 rounding of an fp32
value that differs in its last bits, carried through p @ v: 2e-2 abs on
outputs of O(1) (the same bound the card's check uses).

On the CPU, JAX's ``FiT(attn_impl='fused')`` runs the unfused bounded-
softmax path (the Pallas gate ``supports`` is False on a CPU backend),
while the port runs the fused kernel's plain version: the two agree at
fp32 tolerance, not bit for bit (p is normalised before p @ v in one and
at the end in the other).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.ops import fused_attention as fa

from fitv2_tpu_torch.ckpt import state_dict_from_jax
from fitv2_tpu_torch.kernels import fused_attention as pfa
from fitv2_tpu_torch.models import FiT

SMALL = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=144,
             depth=2, num_heads=2, learn_sigma=False, use_sit=True,
             use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
             adaln_type='lora', adaln_lora_dim=36, num_classes=10,
             max_cached_len=16)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(dtype, masked, b=2, n=32, h=4, dh=6, seed=0):
    """numpy qkv (B, N, 3C), cos/sin (B, N, Dh) f32 and a (B, N) mask whose
    second row has 7 padded tokens and whose third (if any) has none valid."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * h * dh)).astype(np.float32)
    ang = rng.standard_normal((b, n, dh)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    mask = None
    if masked:
        mask = np.ones((b, n), np.float32)
        mask[1, n - 7:] = 0.0
        if b > 2:
            mask[2] = 0.0
    return qkv, cos, sin, mask, h


def _run_both(qkv, cos, sin, mask, h, dtype, norm, jax_fn):
    jdt = jnp.bfloat16 if dtype == 'bf16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bf16' else torch.float32
    want = jax_fn(jnp.asarray(qkv, jdt), jnp.asarray(cos), jnp.asarray(sin),
                  None if mask is None else jnp.asarray(mask), h, 1e-6,
                  *norm)
    got = pfa.fused_qkln_rope_attention_reference(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(cos),
        torch.from_numpy(sin), None if mask is None else
        torch.from_numpy(mask), h, 1e-6, *norm)
    assert got.dtype == tdt
    return got.float().numpy(), np.asarray(want, np.float32)


def _assert_close(got, want, dtype):
    if dtype == 'bf16':
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('masked', [True, False], ids=['masked', 'unmasked'])
@pytest.mark.parametrize('norm', [(True, True), (False, False)],
                         ids=['norm', 'no_norm'])
def test_plain_matches_pallas_kernel(monkeypatch, dtype, masked, norm):
    monkeypatch.setattr(fa, '_INTERPRET', True)
    qkv, cos, sin, mask, h = _inputs(dtype, masked)
    got, want = _run_both(
        qkv, cos, sin, mask, h, dtype, norm,
        lambda a, c, s, m, hh, eps, nq, nk: fa.fused_qkln_rope_attention(
            a, c, s, m, hh, eps, nq, nk))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('masked', [True, False], ids=['masked', 'unmasked'])
def test_plain_matches_pallas_kernel_at_small_cifar_shape(monkeypatch, dtype,
                                                          masked):
    """configs/fitv2_small_cifar.yaml's attention: 64 tokens, hidden 128 over
    4 heads (Dh 32, the head dim the card kernels gained); the mask leaves
    one row full, one partial and one with no valid key."""
    monkeypatch.setattr(fa, '_INTERPRET', True)
    qkv, cos, sin, mask, h = _inputs(dtype, masked, b=3, n=64, h=4, dh=32,
                                     seed=2)
    got, want = _run_both(
        qkv, cos, sin, mask, h, dtype, (True, True),
        lambda a, c, s, m, hh, eps, nq, nk: fa.fused_qkln_rope_attention(
            a, c, s, m, hh, eps, nq, nk))
    _assert_close(got, want, dtype)


def test_every_config_head_dim_is_instantiated():
    """The head dim that attention (K4) and the fused attention (K5) are
    called with, for the model of every config in configs/, is one the card
    kernels are built for, so no config that ``supports`` admits raises on
    the card."""
    import glob
    import os
    from fitv2_tpu_torch.kernels.flash_attention import HEAD_DIMS
    from fitv2_tpu_torch.utils import load_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = {}
    for path in sorted(glob.glob(os.path.join(repo, 'configs', '*.yaml'))):
        net = load_config(path)['diffusion']['network_config']['params']
        c, heads = net['hidden_size'], net['num_heads']
        dh = c // heads
        assert c % heads == 0 and dh in HEAD_DIMS, (path, dh, HEAD_DIMS)
        seen[os.path.basename(path)] = dh
    assert seen['fitv2_small_cifar.yaml'] == 32 and seen['fitv2_xl.yaml'] == 72


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('masked', [True, False], ids=['masked', 'unmasked'])
def test_plain_matches_reference_chain(dtype, masked):
    qkv, cos, sin, mask, h = _inputs(dtype, masked, b=3, n=24, h=2, dh=8,
                                     seed=1)
    got, want = _run_both(qkv, cos, sin, mask, h, dtype, (True, True),
                          fa._reference_chain)
    _assert_close(got, want, dtype)


def test_padded_queries_are_zero_and_masked_keys_ignored():
    qkv, cos, sin, mask, h = _inputs('fp32', True, b=3)
    args = (torch.from_numpy(cos), torch.from_numpy(sin),
            torch.from_numpy(mask), h)
    out = pfa.qkln_rope_attention(torch.from_numpy(qkv), *args)
    assert torch.all(out[torch.from_numpy(mask) == 0] == 0)
    # padded keys do not reach valid queries: changing them changes nothing
    other = qkv.copy()
    other[1, -7:] = 100.0
    out2 = pfa.qkln_rope_attention(torch.from_numpy(other), *args)
    assert torch.equal(out[1, :-7], out2[1, :-7])


def test_wrapper_refuses_cpu_tensors():
    qkv, cos, sin, mask, h = _inputs('fp32', False)
    before = pfa.fused_qkln_rope_attention.launches
    with pytest.raises(ValueError, match='CUDA'):
        pfa.fused_qkln_rope_attention(torch.from_numpy(qkv),
                                      torch.from_numpy(cos),
                                      torch.from_numpy(sin), None, h)
    assert pfa.fused_qkln_rope_attention.launches == before


def test_supports_keeps_the_semantic_gates():
    base = dict(c=1152, num_heads=16, rope_layout='split', q_norm='layernorm',
                k_norm='layernorm', qk_norm_weight=False,
                add_rel_pe_to_v=False, save_attention=False)
    assert pfa.supports(**base)
    assert pfa.supports(**dict(base, q_norm=None, k_norm=None))
    for change in (dict(rope_layout='interleaved'), dict(qk_norm_weight=True),
                   dict(add_rel_pe_to_v=True), dict(save_attention=True),
                   dict(q_norm='rmsnorm'), dict(k_norm='w_layernorm'),
                   dict(c=1152 + 16)):  # odd head dim (73)
        assert not pfa.supports(**dict(base, **change)), change


def _perturbed_params(jm, x, t, y, g, m, s):
    params = jm.init(jax.random.PRNGKey(0), x, t, y, g, m, s)['params']
    rng = np.random.default_rng(0)

    def f(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + 0.05 * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.mark.parametrize('n_h,n_w', [(4, 4), (3, 4)], ids=['full', 'padded'])
def test_fused_fit_matches_jax(n_h, n_w):
    kw = dict(SMALL, attn_impl='fused')
    jm = JFiT(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    t = rng.uniform(size=2).astype(np.float32)
    y = np.array([4, 10])
    g, m, s = (np.array(a) for a in j_grid(2, n_h, n_w, 16))
    params = _perturbed_params(jm, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(y), g, m, s)
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(y), g, m, s))
    pm = FiT(**kw)
    pm.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), depth=2, num_heads=2,
        adaln_type='lora'))
    assert all(b.attn.fused for b in pm.blocks)
    with torch.no_grad():
        got = pm.eval()(*(torch.from_numpy(a) for a in (x, t, y, g, m, s)))
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
