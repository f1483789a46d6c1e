"""PyTorch port, slice 7a: the shared-encoder LwD family
(``models/fit_lwd_sharedenc.py``), ``BFM``, ``config_to_model`` on the LwD
configs, ``lwd_state_from_jax`` and ``cli/sample_lwd`` against the JAX
package on the same weights and numpy inputs.

The small models are ``configs/bfm.yaml`` and ``configs/bfm_xl.yaml``
cut to the JAX tests' sizes (hidden 64, depth 4, 4 heads, K 2, 4 x 4
patches; 2 encoder blocks), each built by both packages'
``config_to_model``, with every parameter randomised on the JAX side
(N(0, 0.05): adaLN-zero would make every output exactly 0) and carried
over by ``lwd_state_from_jax`` into a model loaded with ``strict=True``:
BFM's adaLN-LoRA with no-affine LayerNorm q/k (K2 and K4 on the card), and
BFM-XL's 'normal' adaLN with RMSNorm q/k and GELU MLPs (K3). The SDE
tests replay JAX's ``rng, k = jax.random.split(rng); jax.random.normal(k,
shape)`` chain outside the model.

Tolerances (relative L2, fp32 on both sides; the frameworks sum in other
orders):
- one segment's forward and the encoder's REPA projection: 1e-5;
- ``sample`` and its aux lists, ``sample_cfg`` whole and window-split:
  2e-5;
- the SDE samplers (``sample_maruyama``, ``sample_maruyama_cfg`` with and
  without self-guidance, ``sample_maruyama_global_cfg``), fed JAX's
  draws: 1e-4 (the score divides by 1 - t);
- the CLI against the model's own sampler on the same draws: bit for bit
  (the same operations on the same device).
"""

import os
import warnings

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from fitv2_tpu.models.bfm import BFM as JBFM
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.fit_lwd_sharedenc import (
    FiTLwDSharedEncSepDec as JShared)
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.train import train_step as jts
from fitv2_tpu.utils.config import config_to_model as j_config_to_model

from fitv2_tpu_torch.ckpt import (
    CheckpointManager, lwd_state_from_jax, train_state_from_jax)
from fitv2_tpu_torch.cli import sample_lwd as cli
from fitv2_tpu_torch.models import BFM, FiTLwD, FiTLwDSharedEncSepDec
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.utils.config import (
    MODEL_TARGETS, config_to_model, load_config)

from test_torch_port_lwd import (
    B, SMALL, TOL_SAMPLER, TOL_SDE, TOL_SEGMENT, inputs, jax_and_port,
    jax_draws, japply, rel_l2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# self-guidance scales far above the defaults (1.05, 1.1): at these small
# random weights the defaults move a sample less than the SDE tolerance
GUIDED = dict(self_guidance_scale=16.0, self_guidance_scale_global=16.0)
SHARED = dict(SMALL, number_of_representation_blocks=2, repa_dim=16,
              **GUIDED)
# the variants: the BFM YAMLs, cut (_cut)
VARIANTS = {'lora': 'bfm.yaml', 'normal_rmsnorm': 'bfm_xl.yaml'}
LWD_CONFIGS = ('fitv2_xl_lwd.yaml', 'bfm.yaml', 'bfm_xl.yaml')
LWD_TARGETS = tuple(t for t, (module, _, _) in MODEL_TARGETS.items()
                    if module != 'fit')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cut(name, **extra):
    """configs/``name``'s network at the small size (SHARED's widths and
    depths), its options kept, ``extra`` params added."""
    net = load_config(os.path.join(REPO, 'configs', name))[
        'diffusion']['network_config']
    return dict(net, params=dict(
        net['params'], hidden_size=64, num_heads=4, adaln_lora_dim=16,
        context_size=16, n_patch_h=4, n_patch_w=4, max_cached_len=8,
        depth=4, number_of_perflow=2, number_of_representation_blocks=2,
        repa_dim=16, **extra))


def _build(net):
    """(JAX model, its randomised params, the port's model on them) of
    ``net``, each built by its package's config_to_model."""
    return jax_and_port(j_config_to_model(net), config_to_model(net))


@pytest.fixture(scope='module')
def models():
    return {name: _build(_cut(config, **GUIDED))
            for name, config in VARIANTS.items()}


def _xy():
    x, y = inputs()
    return (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x),
                                              torch.from_numpy(y))


# -- one segment --------------------------------------------------------------

@pytest.mark.parametrize('segment', [0, 1])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_forward_run_layer_matches_jax(models, variant, segment):
    jm, params, pm = models[variant]
    x, y = inputs()
    t = np.array([0.3, 0.8], np.float32)
    g, m, s = j_grid(B, 3, 4, 16)  # padded: 12 of 16 tokens valid
    ref, ref_proj = japply(
        jm, params, lambda mod, *a: mod.forward_run_layer(
            *a[:3], segment, *a[3:]),
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), g, m, s)
    out, proj = pm.forward_run_layer(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
        segment, torch.tensor(np.asarray(g)), torch.tensor(np.asarray(m)),
        torch.tensor(np.asarray(s)))
    assert proj.shape == (B, 16, 16)
    assert rel_l2(out.detach(), ref) <= TOL_SEGMENT
    assert rel_l2(proj.detach(), ref_proj) <= TOL_SEGMENT


def test_forecaster_parameters_cross_over(models):
    """mid_blocks, mid_coefficient and mid_gate, which no sampler reads,
    are in the port's state and carry JAX's values."""
    jm, params, pm = models['lora']
    sd = pm.state_dict()
    np.testing.assert_array_equal(
        sd['mid_gate.adaln_fc_out.weight'].numpy(),
        np.asarray(params['mid_gate']['adaln_fc_out']['kernel']).T)
    np.testing.assert_array_equal(
        sd['mid_blocks.0.attn.qkv.bias'].numpy(),
        np.asarray(params['mid_blocks']['stack']['block']['attn']['qkv'][
            'bias'])[0])
    assert sd['mid_coefficient.fc2.weight'].shape == (1, 32)


# -- samplers -----------------------------------------------------------------

@pytest.mark.parametrize('variant', list(VARIANTS))
def test_sample_matches_jax(models, variant):
    jm, params, pm = models[variant]
    (jx, jy), (px, py) = _xy()
    ref = japply(jm, params, lambda mod, x, y: mod.sample(x, y, 3), jx, jy)
    assert rel_l2(pm.sample(px, py, 3), ref) <= TOL_SAMPLER


def test_sample_aux_family_matches_jax(models):
    """intermediates (after every sub-step), representations (REPA
    projections), semantics (raw encoder tokens) and hidden (the
    decoder's pre-final states)."""
    jm, params, pm = models['lora']
    (jx, jy), (px, py) = _xy()
    ref_x, ref_aux = japply(jm, params, lambda mod, x, y: mod.sample(
        x, y, 2, True, True, True, True), jx, jy)
    out_x, aux = pm.sample(px, py, 2, True, True, True, True)
    assert rel_l2(out_x, ref_x) <= TOL_SAMPLER
    assert set(aux) == set(ref_aux) == {'intermediates', 'representations',
                                        'semantics', 'hidden'}
    for key, values in aux.items():
        assert len(values) == len(ref_aux[key]) == 4
        for o, r in zip(values, ref_aux[key]):
            assert rel_l2(o, r) <= TOL_SAMPLER, key


@pytest.mark.parametrize('window', [(0.0, 1.0), (0.3, 0.7)])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_sample_cfg_matches_jax(models, variant, window):
    """The window splits each segment's sub-steps into CFG and
    conditional-only runs (decided on the float64 ladder)."""
    jm, params, pm = models[variant]
    (jx, jy), (px, py) = _xy()
    ref = japply(jm, params, lambda mod, x, y: mod.sample_cfg(
        x, y, 1.5, 4, *window), jx, jy)
    assert rel_l2(pm.sample_cfg(px, py, 1.5, 4, *window), ref) <= \
        TOL_SAMPLER


def test_sample_maruyama_matches_jax(models):
    jm, params, pm = models['lora']
    (jx, jy), (px, py) = _xy()
    S = 2
    ref, ref_inter = japply(jm, params, lambda mod, r, x, y: (
        mod.sample_maruyama(r, x, y, S, True)), jax.random.PRNGKey(2), jx, jy)
    draws = jax_draws(2, [px.shape] * (2 * S - 1))
    out, inter = pm.sample_maruyama(px, py, S, True, noise=draws)
    assert rel_l2(out, ref) <= TOL_SDE
    assert len(inter) == len(ref_inter) == 2 * S
    assert rel_l2(inter[2], ref_inter[2]) <= TOL_SDE


@pytest.mark.parametrize('variant,self_guidance', [
    ('lora', False), ('lora', True), ('normal_rmsnorm', True)])
def test_sample_maruyama_cfg_matches_jax(models, variant, self_guidance):
    """The window (0.1, 0.8) with and without representation
    self-guidance, one sub-step a segment: t 0 outside the window, 0.5
    inside, then the last segment's step to 1 (its 0.96 rung is
    test_sample_maruyama_matches_jax's, on the same ladder code)."""
    jm, params, pm = models[variant]
    (jx, jy), (px, py) = _xy()
    S = 1
    ref = japply(jm, params, lambda mod, r, x, y: mod.sample_maruyama_cfg(
        r, x, y, 1.4, S, 0.1, 0.8, self_guidance), jax.random.PRNGKey(4),
        jx, jy)
    draws = jax_draws(4, [px.shape] * (2 * S - 1))
    out = pm.sample_maruyama_cfg(px, py, 1.4, S, 0.1, 0.8, self_guidance,
                                 noise=draws)
    assert rel_l2(out, ref) <= TOL_SDE


@pytest.mark.parametrize('self_guidance', [False, True])
def test_sample_maruyama_global_cfg_matches_jax(models, self_guidance):
    """A global ladder of 4 points over [0, 0.96] and a step to 1: the
    segment picked by get_segment_index (0, 0.32 in the first; 0.64, 0.96
    in the second), the batch doubled only inside (0.2, 0.7), with and
    without self-guidance."""
    jm, params, pm = models['lora']
    (jx, jy), (px, py) = _xy()
    steps = 4
    ref = japply(jm, params, lambda mod, r, x, y: (
        mod.sample_maruyama_global_cfg(r, x, y, 1.5, steps, 0.2, 0.7,
                                       self_guidance)),
        jax.random.PRNGKey(8), jx, jy)
    draws = jax_draws(8, [px.shape] * (steps - 1))
    out = pm.sample_maruyama_global_cfg(px, py, 1.5, steps, 0.2, 0.7,
                                        self_guidance, noise=draws)
    assert rel_l2(out, ref) <= TOL_SDE


def test_self_guidance_moves_the_sample_past_the_tolerance(models):
    """The self-guidance parity cases discriminate: guidance moves the
    sample by far more than their tolerance."""
    _, _, pm = models['lora']
    _, (px, py) = _xy()
    draws = [torch.randn(px.shape, generator=torch.Generator().manual_seed(i))
             for i in range(3)]
    a = pm.sample_maruyama_cfg(px, py, 1.4, 2, 0.1, 0.8, False, noise=draws)
    b = pm.sample_maruyama_cfg(px, py, 1.4, 2, 0.1, 0.8, True, noise=draws)
    assert rel_l2(b, a) > 10 * TOL_SDE
    c = pm.sample_maruyama_global_cfg(px, py, 1.5, 5, 0.2, 0.7, False,
                                      noise=draws + draws)
    d = pm.sample_maruyama_global_cfg(px, py, 1.5, 5, 0.2, 0.7, True,
                                      noise=draws + draws)
    assert rel_l2(d, c) > 10 * TOL_SDE


# -- BFM and the configs ------------------------------------------------------

def test_bfm_defaults_match_jax():
    jm = JBFM()
    with torch.device('meta'):
        pm = BFM()
    assert isinstance(pm, FiTLwDSharedEncSepDec)
    for field in ('hidden_size', 'depth', 'num_heads', 'number_of_perflow',
                  'number_of_representation_blocks', 'repa_dim',
                  'adaln_type', 'n_patch_h', 'context_size', 'num_classes',
                  'number_of_mid_blocks', 'self_guidance_scale',
                  'self_guidance_scale_global'):
        assert getattr(pm, field) == getattr(jm, field), field
    assert pm.block_kwargs['adaln_lora_dim'] == jm.adaln_lora_dim == 96
    with torch.device('meta'):
        assert BFM(hidden_size=1152, depth=30).hidden_size == 1152


@pytest.mark.parametrize('name,cls,shape', [
    ('fitv2_xl_lwd.yaml', FiTLwD, (1152, 36, 16, 12, 12)),
    ('bfm.yaml', FiTLwDSharedEncSepDec, (384, 24, 6, 6, 6)),
    ('bfm_xl.yaml', FiTLwDSharedEncSepDec, (1152, 30, 16, 6, 20))])
def test_config_to_model_builds_the_lwd_configs(name, cls, shape):
    net = load_config(os.path.join(REPO, 'configs', name))[
        'diffusion']['network_config']
    with warnings.catch_warnings():
        warnings.simplefilter('error')  # no param of the YAML dropped
        with torch.device('meta'):
            model = config_to_model(net)
    assert type(model) is cls
    assert (model.hidden_size, model.depth, model.num_heads,
            model.number_of_perflow,
            model.number_of_representation_blocks) == shape
    attn = model.segments[0][0].attn
    if name == 'bfm_xl.yaml':
        assert not attn.bounded and not attn.fuse_qk  # K3
        assert len(model.shared_rep_blocks) == 20
        assert sum(p.numel() for p in model.parameters()) == 1_237_442_497
    else:
        assert attn.bounded and attn.fuse_qk  # K2 + K4
    if name == 'fitv2_xl_lwd.yaml':
        assert len(model.segments) == 12 and len(model.segments[0]) == 3
        assert len(model.rep_segments[0]) == 1
        assert model.linear_projection.fc3.out_features == 1024


@pytest.mark.parametrize('target', LWD_TARGETS)
def test_config_to_model_maps_every_lwd_target(target):
    """The reference's, the JAX package's and the port's names of each
    LwD network build the class the JAX package builds."""
    params = dict(SMALL, number_of_representation_blocks=2, repa_dim=16)
    model = config_to_model({'target': target, 'params': params})
    jm = j_config_to_model({'target': target.replace(
        'fitv2_tpu_torch.', 'fitv2_tpu.'), 'params': params})
    want = FiTLwDSharedEncSepDec if isinstance(jm, JShared) else FiTLwD
    assert type(jm) in (JShared, JFiTLwD) and type(model) is want


def test_config_to_model_drops_unknown_params_with_a_warning():
    with pytest.warns(UserWarning, match='not_a_param'):
        model = config_to_model({'target': 'fit.model.bfm.FiT', 'params': dict(
            SHARED, not_a_param=1, pretrain_ckpt='x')})
    assert isinstance(model, FiTLwDSharedEncSepDec)
    with pytest.raises(NotImplementedError, match='not ported'):
        config_to_model({'target': 'fit.model.fit_model_lwd_ms.FiTLwDMS'})


@pytest.mark.parametrize('name', LWD_CONFIGS)
def test_lwd_state_from_jax_loads_each_config(models, name):
    """Every block stack, per-segment list, head and the forecaster of each
    config's JAX tree land in the port's state_dict, strict=True (the BFM
    YAMLs' trees are the models fixture's, cut alike)."""
    net = _cut(name)
    variant = {config: v for v, config in VARIANTS.items()}.get(name)
    jm, params, pm = models[variant] if variant else _build(net)
    params = jax.tree_util.tree_map(np.asarray, params)
    pm.load_state_dict(lwd_state_from_jax(params, pm), strict=True)
    seg = params['segments_1']['stack']['block']['attn']['qkv']['kernel']
    assert torch.equal(pm.segments[1][0].attn.qkv.weight,
                       torch.from_numpy(np.ascontiguousarray(seg[0].T)))
    # a model of another depth does not take the tree
    other = config_to_model(net, depth=2 * net['params']['depth'])
    with pytest.raises(ValueError, match='missing'):
        lwd_state_from_jax(params, other)


def test_train_state_from_jax_carries_an_lwd_state(models):
    jm, params, pm = models['lora']
    tx = jts.make_optimizer(jts.OptimizerConfig(learning_rate=1e-4))
    # under one jit: eager, the optimizer's init compiles leaf by leaf
    init = jax.device_get(jax.jit(
        lambda p: jts.create_train_state(p, tx))(params))
    master = config_to_model(_cut(VARIANTS['lora'], **GUIDED))
    state = train_state_from_jax(init, master, tts.OptimizerConfig())
    want = lwd_state_from_jax(jax.tree_util.tree_map(np.asarray, params), pm)
    assert set(state.ema_params) == set(want)
    for name, t in state.ema_params.items():
        assert torch.equal(t, want[name]), name


# -- the CLI ------------------------------------------------------------------

def _write_run(tmp_path, target, params):
    """A config YAML and a port checkpoint (checkpoint-7, a TrainState of
    randomised weights); returns (cfg path, ckpt dir, the model)."""
    cfg_path = str(tmp_path / 'lwd.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump({'diffusion': {'network_config': {
            'target': target, 'params': params}}}, f)
    model = config_to_model({'target': target, 'params': params})
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    state = tts.create_train_state(model, tts.OptimizerConfig())
    CheckpointManager(str(tmp_path / 'ckpt')).save(7, state.state_dict())
    return cfg_path, str(tmp_path / 'ckpt' / 'checkpoint-7'), model.eval()


@pytest.mark.parametrize('sampler', ['cfg', 'plain', 'maruyama',
                                     'maruyama_global', 'multiscale'])
def test_cli_sample_lwd_reproduces_the_model(tmp_path, sampler):
    """main() on the CPU from a checkpoint the test writes equals the
    model's own sampler on the same labels, noise and draws (the ladder of
    each batch from (--global-seed, batch index)), 3 samples in batches of
    2; latents channel-last as in JAX without a VAE."""
    if sampler == 'multiscale':
        target = 'fit.model.fit_model_lwd.FiTLwD'
        params = dict(SMALL, depth=12, number_of_perflow=12, context_size=64,
                      n_patch_h=8, n_patch_w=8, max_cached_len=16)
    else:
        target = 'fit.model.bfm.FiT'
        params = dict(SHARED, adaln_lora_dim=16)
    cfg_path, ckpt, model = _write_run(tmp_path, target, params)
    out = str(tmp_path / 'samples.npz')
    extra = {'maruyama': ['--self-guidance', '--guidance-low', '0.1',
                          '--guidance-high', '0.8'],
             'maruyama_global': ['--global-steps', '6', '--self-guidance'],
             }.get(sampler, [])
    cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt, '--sampler', sampler,
              '--steps-per-flow', '2', '--num-fid-samples', '3',
              '--per-device-batch', '2', '--global-seed', '5', '--device',
              'cpu', '--out', out, *extra])
    arr = np.load(out)['arr_0']
    hw = 2 * params['n_patch_h']
    assert arr.shape == (3, hw, hw, 4) and arr.dtype == np.float32
    args = cli.parse_args(['--cfgdir', cfg_path, '--ckpt', ckpt,
                           '--sampler', sampler, '--steps-per-flow', '2',
                           *extra])
    fn = cli.sampler_fn(model, args)
    tokens = params['n_patch_h'] ** 2 // (16 if sampler == 'multiscale'
                                          else 1)
    want = []
    for bi in range(2):
        y, z, gen = cli.batch_inputs(5, bi, 2, tokens, 16, 10)
        want.append(model.unpatchify(fn(z, y, gen), (hw, hw),
                                     channel_last=True).numpy())
    np.testing.assert_array_equal(arr, np.concatenate(want)[:3])


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    cfg_path, ckpt, _ = _write_run(tmp_path, 'fit.model.bfm.FiT',
                                   dict(SHARED, adaln_lora_dim=16))
    with pytest.raises(RuntimeError, match='no CUDA'):
        cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt])
