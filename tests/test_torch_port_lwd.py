"""PyTorch port, slice 7a: FiTLwD (``models/fit_lwd.py``) and its modules
(``models/modules_lwd.py``) against the JAX package on the same weights and
numpy inputs.

The models are the JAX tests' small ones (``tests/test_lwd.py``: hidden
64, depth 4, 4 heads, K 2, 4 x 4 patches, adaLN-LoRA 16). Every parameter
is randomised on the JAX side (N(0, 0.05), as ``tests/test_lwd.py`` does:
adaLN-zero would make every output exactly zero) and carried over by
``lwd_state_from_jax`` into a model loaded with ``strict=True``.
``jax.random`` and torch streams never match, so the SDE and multi-scale
tests replay JAX's ``rng, k = jax.random.split(rng); jax.random.normal(k,
shape)`` chain outside the model and hand the draws to the port.

Tolerances (relative L2, fp32 on both sides; the two frameworks sum in
other orders and differ by transcendental ulps):
- one segment's forward (``forward_run_layer``) and the REPA projection:
  1e-5;
- the deterministic samplers (``sample``, its aux outputs,
  ``sample_cfg``, ``sample_multiscale``): 2e-5;
- the SDE sampler, fed JAX's draws: 1e-4 (the score divides by 1 - t);
- the modules, the block noise, the REPA loss and ``unpatchify``: 1e-6
  of the largest magnitude (a few operations on O(1) values);
- the ladders and the segment index: exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.models import modules_lwd as jmods
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.fit_lwd import repa_alignment_loss as j_repa_loss
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid

from fitv2_tpu_torch.ckpt import lwd_state_from_jax
from fitv2_tpu_torch.ckpt.convert import _flatten, _leaf
from fitv2_tpu_torch.models import FiTLwD, repa_alignment_loss
from fitv2_tpu_torch.models import modules_lwd as mods

TOL_SEGMENT = 1e-5
TOL_SAMPLER = 2e-5
TOL_SDE = 1e-4
TOL_SMALL = 1e-6
SMALL = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
             depth=4, num_heads=4, num_classes=10, number_of_perflow=2,
             n_patch_h=4, n_patch_w=4, adaln_type='lora', adaln_lora_dim=16,
             max_cached_len=8)
# every option of the family: REPA blocks, per-segment embedders, the
# shared trunk and the Fourier basis; then BFM-XL's 'normal' adaLN with
# RMSNorm q/k (K3) and GELU MLPs
VARIANTS = {
    'lora': {},
    'repa_perlayer_trunk_fourier': dict(
        number_of_representation_blocks=2, repa_dim=24,
        perlayer_embedder=True, number_of_shared_blocks=1,
        fourier_basis=True),
    'normal_rmsnorm': dict(adaln_type='normal', q_norm='rmsnorm',
                           k_norm='rmsnorm', use_swiglu=False,
                           time_shifting=2.0),
}
B = 2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def randomize(shapes, seed=0, scale=0.05):
    """A param tree of ``shapes``' leaves, each N(0, scale), seeded
    (tests/test_lwd.py's randomisation)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda v: jnp.asarray(
        rng.standard_normal(v.shape).astype(np.float32) * scale), shapes)


def jax_and_port(jm, pm, seed=0):
    """(the JAX model ``jm``, randomised params of its tree, ``pm``, the
    port's model of the same network, on them). The tree's shapes come
    from tracing ``init`` (every value is replaced)."""
    n = jm.context_size
    g, m, s = j_grid(B, jm.n_patch_h, jm.n_patch_w, n)
    shapes = jax.eval_shape(
        jm.init, {'params': jax.random.PRNGKey(seed),
                  'label_dropout': jax.random.PRNGKey(seed + 1)},
        jnp.zeros((B, n, 16)), jnp.zeros((B,)), jnp.zeros((B,), jnp.int32),
        g, m, s)['params']
    params = randomize(shapes, seed)
    pm.load_state_dict(lwd_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pm), strict=True)
    return jm, params, pm.eval()


def japply(jm, params, fn, *arrays):
    """``fn(module, *arrays)`` applied under one jit (an eager apply
    compiles op by op: 3-4x slower at these sizes). XLA's backend
    optimisation is off: it halves the compile, which is most of these
    tests' time, and moves the outputs by ~1e-7 relative L2."""
    return jax.jit(lambda p, *a: jm.apply({'params': p}, *a, method=fn),
                   compiler_options={'xla_backend_optimization_level': 0})(
        params, *arrays)


def jax_draws(seed, shapes):
    """JAX's sampler draws: rng, k = split(rng); normal(k, shape) each."""
    rng, out = jax.random.PRNGKey(seed), []
    for shape in shapes:
        rng, k = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32))))
    return out


def inputs(n=16, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 16)).astype(np.float32)
    y = np.array([3, 7])
    return x, y


@pytest.fixture(scope='module')
def models():
    kws = {name: dict(SMALL, **kw) for name, kw in VARIANTS.items()}
    return {name: jax_and_port(JFiTLwD(**kw), FiTLwD(**kw))
            for name, kw in kws.items()}


# -- modules ------------------------------------------------------------------

def _module_pair(jmod, pmod, *args, seed=0):
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(seed),
                                      *args)['params'], seed, scale=0.3)
    pmod.load_state_dict(dict(_leaf(k, v) for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, params)).items()), strict=True)
    out = jmod.apply({'params': params}, *args)
    return out, pmod(*[torch.from_numpy(np.asarray(a)) for a in args])


@pytest.mark.parametrize('case', ['final_nomod', 'coefficient', 'srn',
                                  'srn_swiglu_per_token'])
def test_modules_lwd_match_jax(case):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 6, 32)).astype(np.float32)
    c = rng.standard_normal((B, 32)).astype(np.float32)
    c_tok = rng.standard_normal((B, 6, 32)).astype(np.float32)
    if case == 'final_nomod':
        ref, out = _module_pair(jmods.FinalLayerNoModulation(32, 2, 4),
                                mods.FinalLayerNoModulation(32, 2, 4), x)
    elif case == 'coefficient':
        ref, out = _module_pair(jmods.TimestepDependentCoefficient(32),
                                mods.TimestepDependentCoefficient(32), c)
        assert out.shape == (B, 1)
    elif case == 'srn':
        ref, out = _module_pair(jmods.SRN(32, 2, 32),
                                mods.SRN(32, 2, 32), x, c)
    else:
        ref, out = _module_pair(
            jmods.SRN(32, 2, 16, adaln_type='swiglu'),
            mods.SRN(32, 2, 16, adaln_type='swiglu'), x, c_tok)
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= \
        TOL_SMALL * np.abs(ref).max()


def test_module_inits_match_jax():
    """The coefficient starts at sigmoid(-4.6) and SRN's projection at 0,
    as in JAX (the forecaster's starting point)."""
    coeff = mods.TimestepDependentCoefficient(32)
    out = coeff(torch.randn(3, 32))
    np.testing.assert_allclose(out.detach().numpy(),
                               1 / (1 + np.exp(4.6)), rtol=1e-6)
    srn = mods.SRN(32, 2, 8)
    assert torch.equal(srn(torch.randn(2, 5, 32), torch.randn(2, 32)),
                       torch.full((2, 5, 8), 0.5))


# -- one segment --------------------------------------------------------------

@pytest.mark.parametrize('segment', [0, 1])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_forward_run_layer_matches_jax(models, variant, segment):
    jm, params, pm = models[variant]
    x, y = inputs()
    t = np.array([0.3, 0.8], np.float32)
    # a padded grid (3 x 4 of 16 tokens): the mask reaches the attention
    g, m, s = j_grid(B, 3, 4, 16)
    ref, ref_proj = japply(
        jm, params, lambda mod, *a: mod.forward_run_layer(
            *a[:3], segment, *a[3:]),
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), g, m, s)
    out, proj = pm.forward_run_layer(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
        segment, torch.tensor(np.asarray(g)), torch.tensor(np.asarray(m)),
        torch.tensor(np.asarray(s)))
    assert rel_l2(out.detach(), ref) <= TOL_SEGMENT
    assert not np.asarray(ref)[:, 12:].any()  # padded tokens zeroed
    if ref_proj is None:
        assert proj is None
    else:
        assert proj.shape == (B, 16, 24)
        assert rel_l2(proj.detach(), ref_proj) <= TOL_SEGMENT


def test_segments_use_their_own_weights(models):
    _, _, pm = models['lora']
    x, y = inputs()
    g, m, s = (torch.tensor(np.asarray(a)) for a in j_grid(B, 4, 4, 16))
    t = torch.tensor([0.3, 0.8])
    out0, _ = pm.forward_run_layer(torch.from_numpy(x), t,
                                   torch.from_numpy(y), 0, g, m, s)
    out1, _ = pm.forward_run_layer(torch.from_numpy(x), t,
                                   torch.from_numpy(y), 1, g, m, s)
    assert (out0 - out1).abs().max() > 1e-3


# -- samplers -----------------------------------------------------------------

@pytest.mark.parametrize('variant', ['lora', 'repa_perlayer_trunk_fourier',
                                     'normal_rmsnorm'])
def test_sample_matches_jax(models, variant):
    jm, params, pm = models[variant]
    x, y = inputs()
    ref = japply(jm, params, lambda mod, x, y: mod.sample(x, y, 3),
                 jnp.asarray(x), jnp.asarray(y))
    out = pm.sample(torch.from_numpy(x), torch.from_numpy(y), 3)
    assert rel_l2(out, ref) <= TOL_SAMPLER


def test_sample_aux_matches_jax(models):
    """return_intermediates and return_representations (the unrolled
    sub-steps, REPA projections at each segment's first sub-step)."""
    jm, params, pm = models['repa_perlayer_trunk_fourier']
    x, y = inputs()
    ref = japply(jm, params, lambda mod, x, y: mod.sample(x, y, 2, True,
                                                          True),
                 jnp.asarray(x), jnp.asarray(y))
    out = pm.sample(torch.from_numpy(x), torch.from_numpy(y), 2, True, True)
    assert len(out) == 3
    assert out[1].shape == (2, B, 16, 16) and out[2].shape == (2, B, 16, 24)
    for o, r in zip(out, ref):
        assert rel_l2(o, r) <= TOL_SAMPLER
    # without representation blocks the representations are None
    jm, params, pm = models['lora']
    x_out, reps = pm.sample(torch.from_numpy(x), torch.from_numpy(y), 1,
                            return_representations=True)
    assert reps is None


@pytest.mark.parametrize('variant', ['lora', 'normal_rmsnorm'])
def test_sample_cfg_matches_jax(models, variant):
    jm, params, pm = models[variant]
    x, y = inputs()
    ref = japply(jm, params, lambda mod, x, y: mod.sample_cfg(x, y, 1.5, 3),
                 jnp.asarray(x), jnp.asarray(y))
    out = pm.sample_cfg(torch.from_numpy(x), torch.from_numpy(y), 1.5, 3)
    assert rel_l2(out, ref) <= TOL_SAMPLER


@pytest.mark.parametrize('window', [(0.0, 1.0), (0.2, 0.8)])
def test_sample_maruyama_cfg_matches_jax(models, window):
    """JAX's draws (one a sub-step, none at the very last) replayed; the
    last segment's ladder runs to 0.96, then one step to 1."""
    jm, params, pm = models['lora']
    x, y = inputs()
    S = 2
    ref = japply(jm, params, lambda mod, r, x, y: mod.sample_maruyama_cfg(
        r, x, y, 1.4, S, *window), jax.random.PRNGKey(5), jnp.asarray(x),
        jnp.asarray(y))
    draws = jax_draws(5, [x.shape] * (SMALL['number_of_perflow'] * S - 1))
    out = pm.sample_maruyama_cfg(torch.from_numpy(x), torch.from_numpy(y),
                                 1.4, S, *window, noise=draws)
    assert rel_l2(out, ref) <= TOL_SDE
    # a generator draws the same as the noise it would give as a callable
    gen_out = pm.sample_maruyama_cfg(
        torch.from_numpy(x), torch.from_numpy(y), 1.4, S, *window,
        generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    call_out = pm.sample_maruyama_cfg(
        torch.from_numpy(x), torch.from_numpy(y), 1.4, S, *window,
        noise=lambda shape: torch.randn(shape, generator=g))
    assert torch.equal(gen_out, call_out)


def test_segment_ladders_and_index_equal_jax():
    jm, pm = JFiTLwD(**SMALL), FiTLwD(**SMALL)
    assert np.array_equal(pm.sigmas, jm.sigmas)
    for i in range(2):
        for S in (1, 3, 7):
            for last in (False, True):
                assert np.array_equal(pm._segment_sigma_list(i, S, last),
                                      jm._segment_sigma_list(i, S, last))
    for t in (0.0, 0.25, 0.4999, 0.5, 0.96, 1.0):
        assert pm.get_segment_index(t) == jm.get_segment_index(t)


# -- multi-scale --------------------------------------------------------------

MS = dict(context_size=64, patch_size=2, in_channels=4, hidden_size=32,
          depth=4, num_heads=2, num_classes=10, number_of_perflow=4,
          n_patch_h=8, n_patch_w=8, adaln_type='lora', adaln_lora_dim=8,
          max_cached_len=16)


def test_block_noise_matches_jax():
    jm, pm = JFiTLwD(**MS), FiTLwD(**MS)
    shape = (3, 8, 6, 4)
    ref = jm.sample_block_noise(jax.random.PRNGKey(0), shape, 0.25)
    z = jax.random.normal(jax.random.PRNGKey(0), (3, 4, 3, 4, 4),
                          jnp.float32)
    out = pm.sample_block_noise(shape, 0.25,
                                noise=[torch.from_numpy(np.array(z))])
    assert out.shape == shape
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= TOL_SMALL
    # at gamma 1/3 each 2x2 block sums to 0 (JAX's own statistics test)
    big = pm.sample_block_noise((64, 4, 4, 8), 1 / 3,
                                generator=torch.Generator().manual_seed(0))
    assert big.reshape(64, 2, 2, 2, 2, 8).sum((2, 4)).abs().max() < 1e-3
    assert abs(big.var().item() - 1.0) < 0.05


def test_repatchify_inverts_unpatchify():
    pm = FiTLwD(**MS)
    x = torch.randn(2, 64, 16)
    img = pm.unpatchify(x, (16, 16), channel_last=True)
    assert torch.equal(pm._repatchify(img), x)


def test_sample_multiscale_matches_jax():
    """4 x 4 -> 8 x 8 tokens over per_blocks (1, 1, 2) with boundaries at
    segments 1 and 2 (one block-noise draw each, JAX's chain replayed),
    nearest 2x upsampling and the alpha / beta renoising."""
    jm, params, pm = jax_and_port(JFiTLwD(**MS), FiTLwD(**MS), seed=3)
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((B, 4, 16)).astype(np.float32)
    y = np.array([1, 2])
    ref = japply(jm, params, lambda mod, r, x, y: mod.sample_multiscale(
        r, x, y, 1, (1, 2), (1, 1, 2)), jax.random.PRNGKey(6),
        jnp.asarray(x0), jnp.asarray(y))
    # the grid grows 2 x 2 -> 4 x 4 -> 8 x 8 tokens: latents 8 x 8, then
    # 16 x 16, each drawn as (B, H/2, W/2, C, 4)
    draws = jax_draws(6, [(B, 4, 4, 4, 4), (B, 8, 8, 4, 4)])
    out = pm.sample_multiscale(torch.from_numpy(x0), torch.from_numpy(y), 1,
                               (1, 2), (1, 1, 2), noise=draws)
    assert out.shape == (B, 64, 16)
    assert rel_l2(out, ref) <= TOL_SAMPLER
    with pytest.raises(ValueError, match='per_blocks'):
        pm.sample_multiscale(torch.from_numpy(x0), torch.from_numpy(y), 1,
                             (1, 2), (1, 1, 1))


# -- REPA, unpatchify, refusals -----------------------------------------------

@pytest.mark.parametrize('masked', [False, True])
def test_repa_alignment_loss_matches_jax(masked):
    rng = np.random.default_rng(7)
    proj = rng.standard_normal((3, 10, 12)).astype(np.float32)
    target = rng.standard_normal((3, 10, 12)).astype(np.float32)
    mask = (rng.uniform(size=(3, 10)) > 0.3).astype(np.float32) \
        if masked else None
    ref = np.asarray(j_repa_loss(jnp.asarray(proj), jnp.asarray(target),
                                 None if mask is None else jnp.asarray(mask)))
    out = repa_alignment_loss(torch.from_numpy(proj),
                              torch.from_numpy(target),
                              None if mask is None else torch.from_numpy(mask))
    assert out.shape == (3,)
    assert np.abs(out.numpy() - ref).max() <= TOL_SMALL


def test_unpatchify_matches_jax():
    jm, pm = JFiTLwD(**SMALL), FiTLwD(**SMALL)
    x = np.random.default_rng(8).standard_normal((2, 16, 16)).astype(
        np.float32)
    for channel_last in (False, True):
        ref = jm.unpatchify(jnp.asarray(x), (8, 8), channel_last)
        out = pm.unpatchify(torch.from_numpy(x), (8, 8), channel_last)
        assert np.array_equal(out.numpy(), np.asarray(ref))


def test_unported_options_raise():
    # int8 serving is ported (its parity is test_torch_port_int8_lwd.py):
    # every block's qkv, proj, fc1 and fc2 are Int8Linear
    from fitv2_tpu_torch.kernels.quant import int8_layers
    assert len(int8_layers(FiTLwD(**SMALL, gemm_precision='int8'))) == \
        4 * SMALL['depth']
    with pytest.raises(ValueError, match='gemm_precision'):
        FiTLwD(**SMALL, gemm_precision='fp8')
    # sequence parallelism is ported (test_torch_port_sharding.py): in one
    # process the mesh's sequence axis has extent 1 and nothing splits
    from fitv2_tpu_torch.parallel import build_mesh
    mesh = build_mesh()
    assert FiTLwD(**SMALL, sequence_mesh=mesh).sequence_mesh is mesh
    with pytest.raises(ValueError, match='segments'):
        FiTLwD(**dict(SMALL, depth=5))


def test_untrained_model_samples_the_identity():
    """adaLN-zero and zero final layers: an untrained FiTLwD's velocity is
    exactly 0, so every deterministic sampler returns its input."""
    pm = FiTLwD(**SMALL).eval()
    x, y = inputs()
    out = pm.sample_cfg(torch.from_numpy(x), torch.from_numpy(y), 1.5, 2)
    assert torch.equal(out, torch.from_numpy(x))
