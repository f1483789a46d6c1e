"""PyTorch port (fitv2_tpu_torch.models / ckpt): RoPE, grid, FiT forward and
weight carry-over against the JAX package and the committed forward golden.

A small FiTv2 (hidden 144, 2 heads of Dh 72, depth 2, context 16, adaLN-LoRA
36, SwiGLU, qk-LN) runs in both packages on the same numpy inputs; the JAX
params cross over through ``state_dict_from_jax``. The zero-init leaves
(adaLN ``fc_out``, ``final_layer/linear``) are perturbed first: an untrained
FiT outputs exactly 0 and parity would be vacuous.

Tolerances: fp32 end to end; the two frameworks differ in summation order
and in fp32 transcendental ulps (2e-5 abs/rel for model outputs of O(1)).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.ckpt.torch_export import export_fit_state_dict, save_safetensors
from fitv2_tpu.models import grid_utils as jgrid
from fitv2_tpu.models import rope as jrope
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.fit import forward_with_cfg as j_forward_with_cfg

from fitv2_tpu_torch.ckpt import (
    convert_fit_state_dict, load_fit_checkpoint, load_torch_state_dict,
    state_dict_from_jax)
from fitv2_tpu_torch.models import FiT, forward_with_cfg
from fitv2_tpu_torch.models import grid_utils, rope
from fitv2_tpu_torch.models.modules import Attention, TimestepEmbedder

ATOL = RTOL = 2e-5
SMALL = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=144,
             depth=2, num_heads=2, learn_sigma=False, use_sit=True,
             use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
             adaln_type='lora', adaln_lora_dim=36, num_classes=10,
             max_cached_len=16)
GOLD = np.load(os.path.join(os.path.dirname(__file__), 'goldens',
                            'fit_forward.npz'))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def perturb_zero_init(params, seed=0, scale=0.05):
    """Seeded noise on the zero-initialised leaves of a JAX FiT tree."""
    rng = np.random.default_rng(seed)

    def f(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p or "'fc2'" in p:
            return v + scale * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def jax_and_port(kw, batch=2, n_h=4, n_w=4, seed=0):
    """(JAX model, params, port model with the same weights, inputs)."""
    jm = JFiT(**kw)
    n_ctx = kw['context_size']
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n_ctx, 16)).astype(np.float32)
    t = rng.uniform(size=batch).astype(np.float32)
    y = rng.integers(0, kw['num_classes'] + 1, size=batch)
    g, m, s = jgrid.make_grid_mask_size(batch, n_h, n_w, n_ctx)
    mask = None if n_h * n_w == n_ctx else m
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     jnp.asarray(t), jnp.asarray(y), g, mask, s)['params']
    params = perturb_zero_init(params, seed)
    pm = FiT(**kw)
    pm.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), depth=kw['depth'],
        num_heads=kw['num_heads'], adaln_type=kw['adaln_type'],
        rope_layout=kw.get('rope_layout', 'split')))
    return jm, params, pm.eval(), (x, t, y, g, mask, s)


def _port_inputs(inputs):
    x, t, y, g, mask, s = inputs
    return (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
            torch.tensor(np.asarray(g)),
            None if mask is None else torch.tensor(np.asarray(mask)),
            torch.tensor(np.asarray(s)))


# -- grid + RoPE ---------------------------------------------------------------

def test_grid_utils_match_jax():
    assert np.array_equal(grid_utils.make_grid(3, 5), jgrid.make_grid(3, 5))
    ours = grid_utils.make_grid_mask_size(2, 3, 4, 16)
    theirs = jgrid.make_grid_mask_size(2, 3, 4, 16)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert grid_utils.pixels_to_tokens(160, 320) == (10, 20)
    with pytest.raises(ValueError):
        grid_utils.pixels_to_tokens(100, 256)


@pytest.mark.parametrize('mode', ['normal', 'linear', 'ntk-aware',
                                  'ntk-aware-pro1', 'ntk-aware-pro2',
                                  'ntk-by-parts', 'yarn'])
@pytest.mark.parametrize('layout', ['split', 'interleaved'])
def test_rope_tables_match_jax(mode, layout):
    kw = dict(head_dim=72, mode=mode, max_cached_len=40, max_pe_len_h=24,
              max_pe_len_w=32, ori_max_pe_len=16, decouple=mode == 'yarn',
              layout=layout)
    ours = rope.build_rope_cache(rope.RopeConfig(**kw))
    theirs = jrope.build_rope_cache(jrope.RopeConfig(**kw))
    for name in ours:
        # angles up to 40 rad: an fp32 ulp in a frequency moves cos/sin ~1e-5
        _close(ours[name], theirs[name], atol=3e-5, rtol=3e-5)
    grid = np.array(jgrid.make_grid_mask_size(2, 5, 7, 40)[0])
    oc, os_ = rope.rope_from_grid(ours, torch.from_numpy(grid), layout)
    tc, ts = jrope.rope_from_grid(theirs, jnp.asarray(grid), layout)
    _close(oc, tc, atol=3e-5, rtol=3e-5)
    _close(os_, ts, atol=3e-5, rtol=3e-5)


def test_rope_freqs_per_sample_and_rotations():
    sizes = np.array([8.0, 16.0, 40.0], np.float32)
    for mode in ('linear', 'ntk-aware', 'ntk-by-parts', 'yarn'):
        _close(rope.get_1d_rope_freqs(mode, 10000.0, 36, torch.from_numpy(
            sizes), 16), jrope.get_1d_rope_freqs(mode, 10000.0, 36, sizes, 16))
    x = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(np.float32)
    assert np.array_equal(rope.rotate_half(torch.from_numpy(x)).numpy(),
                          np.asarray(jrope.rotate_half(jnp.asarray(x))))
    assert np.array_equal(
        rope.rotate_half_split(torch.from_numpy(x)).numpy(),
        np.asarray(jrope.rotate_half_split(jnp.asarray(x))))
    assert np.array_equal(rope.split_permutation(72),
                          jrope.split_permutation(72))


def test_timestep_sinusoid_is_cos_first():
    t = np.array([0.0, 0.3, 0.99], np.float32)
    ours = TimestepEmbedder.timestep_embedding(torch.from_numpy(t), 256)
    from fitv2_tpu.models.modules import TimestepEmbedder as JTE
    _close(ours, JTE.timestep_embedding(jnp.asarray(t), 256))
    assert torch.allclose(ours[0, :128], torch.ones(128))  # cos(0) first


# -- FiT forward ---------------------------------------------------------------

@pytest.mark.parametrize('bucket', [(4, 4), (3, 4)], ids=['full', 'padded'])
def test_fit_forward_matches_jax(bucket):
    jm, params, pm, inputs = jax_and_port(SMALL, n_h=bucket[0],
                                          n_w=bucket[1])
    x, t, y, g, mask, s = inputs
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(y), g, mask, s))
    with torch.no_grad():
        got = pm(*_port_inputs(inputs)).numpy()
    assert np.abs(want).max() > 0.1  # not the vacuous all-zero output
    _close(got, want)
    if mask is not None:  # padded tokens are zeroed
        assert not got[:, 12:].any()


@pytest.mark.parametrize('variant', [
    dict(time_shifting=3.0),
    dict(rope_layout='interleaved', qk_norm_weight=True),
    dict(adaln_type='normal', q_norm=None, k_norm=None),
    dict(adaln_type='swiglu', use_swiglu=False),
], ids=['time_shift', 'interleaved_wln', 'normal_noqk', 'swiglu_adaln'])
def test_fit_variants_match_jax(variant):
    """The paths off the hot config: the time shift, the unfused q/k norm +
    RoPE chain (interleaved basis, weighted LN, unbounded softmax), the
    'normal' and 'swiglu' adaLN heads and the GELU MLP."""
    kw = dict(SMALL, **variant)
    jm, params, pm, inputs = jax_and_port(kw, n_h=3, n_w=4, seed=1)
    x, t, y, g, mask, s = inputs
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(y), g, mask, s))
    with torch.no_grad():
        got = pm(*_port_inputs(inputs)).numpy()
    assert np.abs(want).max() > 0.1
    _close(got, want)


def test_forward_with_cfg_and_unpatchify_match_jax():
    jm, params, pm, inputs = jax_and_port(SMALL, batch=4, seed=2)
    x, t, y, g, mask, s = inputs
    want = np.asarray(j_forward_with_cfg(
        jm, params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), g, mask,
        s, 1.5))
    tx, tt, ty, tg, tm, ts = _port_inputs(inputs)
    with torch.no_grad():
        got = forward_with_cfg(pm, tx, tt, ty, tg, tm, ts, 1.5)
    _close(got, want)
    for channel_last in (False, True):
        assert np.array_equal(
            pm.unpatchify(torch.from_numpy(x), (8, 8), channel_last).numpy(),
            np.asarray(jm.unpatchify(jnp.asarray(x), (8, 8), channel_last)))


def test_untrained_fit_outputs_zero_velocity():
    """The trap every parity check must avoid: adaLN-zero + the zero-init
    final layer make a fresh FiT (either package) output exactly 0."""
    pm = FiT(**SMALL).eval()
    x = torch.randn(2, 16, 16)
    g, _, s = grid_utils.make_grid_mask_size(2, 4, 4, 16)
    with torch.no_grad():
        out = pm(x, torch.rand(2), torch.tensor([0, 10]), g, None, s)
    assert not out.any()


def test_fit_matches_committed_torch_golden():
    """The reference-layout golden weights, loaded through the port's
    checkpoint converter (split-basis permutation included), reproduce the
    committed torch output (tools/gen_goldens.py)."""
    sd = {k[len('sd.'):]: torch.from_numpy(GOLD[k]) for k in GOLD.files
          if k.startswith('sd.')}
    pm = FiT(context_size=32, patch_size=int(GOLD['p']),
             in_channels=int(GOLD['in_ch']), hidden_size=int(GOLD['dim']),
             depth=int(GOLD['depth']), num_heads=int(GOLD['heads']),
             num_classes=int(GOLD['ncls']), learn_sigma=False,
             use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
             adaln_type='lora', adaln_lora_dim=16, max_cached_len=64)
    pm.load_state_dict(convert_fit_state_dict(
        sd, depth=pm.depth, adaln_type='lora', num_heads=pm.num_heads))
    with torch.no_grad():
        out = pm(*(torch.from_numpy(GOLD[k]) for k in ('x', 't', 'y', 'grid',
                                                       'mask')))
    # same tolerance as the JAX package's own golden test
    _close(out, GOLD['out'], atol=2e-4, rtol=2e-4)


# -- weights ---------------------------------------------------------------------

def test_state_dict_from_jax_equals_exported_checkpoint(tmp_path):
    """JAX params -> state_dict_from_jax equals JAX params -> reference
    export -> safetensors -> the port's checkpoint loader, tensor for tensor."""
    jm, params, pm, _ = jax_and_port(SMALL, seed=3)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    direct = state_dict_from_jax(pnp, depth=2, num_heads=2,
                                 adaln_type='lora')
    path = str(tmp_path / 'fit.safetensors')
    save_safetensors(export_fit_state_dict(pnp, depth=2, adaln_type='lora',
                                           num_heads=2, rope_layout='split'),
                     path)
    via_ckpt = convert_fit_state_dict(
        {'_orig_mod.' + k: v for k, v in load_torch_state_dict(path).items()},
        depth=2, adaln_type='lora', num_heads=2, rope_layout='split')
    assert set(direct) == set(via_ckpt) == set(pm.state_dict())
    for k in direct:
        assert torch.equal(direct[k], via_ckpt[k]), k
    loaded = load_fit_checkpoint(path, FiT(**SMALL))
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, direct[k]), k


def test_converter_rejects_leftover_keys():
    sd = {'x_embedder.proj.weight': torch.zeros(144, 16),
          'unknown.weight': torch.zeros(1)}
    with pytest.raises(ValueError, match='unconverted'):
        convert_fit_state_dict(sd, depth=0, num_heads=2)


def test_unported_options_raise():
    # online RoPE is ported (tests/test_torch_port_hr.py); it builds
    assert FiT(**dict(SMALL, online_rope=True, custom_freqs='ntk-aware',
                      ori_max_pe_len=4)).rope_config.online
    # the captures are ported (tests/test_torch_port_attention_viz.py): they
    # build, and rel-PE on v takes the interleaved layout and no fused q/k
    assert Attention(144, 2, save_attention=True).save_attention
    attn = Attention(144, 2, q_norm='layernorm', k_norm='layernorm',
                     add_rel_pe_to_v=True)
    assert attn.rope_layout == 'interleaved' and not attn.fuse_qk
    # JAX's XLA attention implementations have no counterpart
    with pytest.raises(ValueError, match='attn_impl'):
        Attention(144, 2, attn_impl='xla')


def test_int8_and_fused_options_build():
    """The int8 serving mode and the fused attention path are ported: the
    options build, keep the checkpoint's parameter names, and refuse what
    JAX does not have."""
    from fitv2_tpu_torch.kernels.quant import Int8Linear
    dense = FiT(**SMALL)
    q = FiT(**dict(SMALL, gemm_precision='int8'))
    assert set(q.state_dict()) == set(dense.state_dict())
    blk = q.blocks[0]
    for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
        assert isinstance(lin, Int8Linear)
    assert not isinstance(blk.adaLN_modulation.fc_out, Int8Linear)
    assert not isinstance(q.final_layer.linear, Int8Linear)
    assert isinstance(Attention(144, 2, quantized=True).qkv, Int8Linear)
    assert Attention(144, 2, attn_impl='fused', q_norm='layernorm',
                     k_norm='layernorm').fused
    # ineligible configurations fall through to the unfused path, as in JAX
    assert not Attention(144, 2, attn_impl='fused',
                         rope_layout='interleaved').fused
    assert not Attention(144, 2, attn_impl='fused', q_norm='layernorm',
                         k_norm='layernorm', qk_norm_weight=True).fused
    with pytest.raises(ValueError, match='gemm_precision'):
        FiT(**dict(SMALL, gemm_precision='fp8'))
    with pytest.raises(ValueError, match='attn_impl'):
        Attention(144, 2, attn_impl='pallas')
