"""PyTorch port (fitv2_tpu_torch.eval.attention_viz, the FiT's
``save_attention`` and ``add_rel_pe_to_v``, the sampler's trajectory,
cli/visualize_attention) against the JAX package on the same weights and
inputs.

Small FiTs (hidden 64, 2 heads of Dh 32, depth 2, context 16) run in both
packages; the JAX params, every leaf random (an untrained FiT outputs 0),
cross over through ``state_dict_from_jax``. The captured
maps are probabilities: 1e-5 absolute. The rollout, heatmap and overlay
take the same maps in both packages: 1e-6, and the uint8 overlay within
one level (the bilinear weights' rounding). rel-PE on v: one forward,
1e-5 relative L2. The trajectory: 4 fp32 Euler steps on JAX's own noise,
1e-5 relative L2 per step.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.eval import attention_viz as jviz
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.sample import SamplingConfig as JSamplingConfig
from fitv2_tpu.sample import build_sampler as j_build_sampler

from fitv2_tpu_torch.ckpt import lwd_state_from_jax, state_dict_from_jax
from fitv2_tpu_torch.cli import visualize_attention as cli
from fitv2_tpu_torch.eval import attention_viz as viz
from fitv2_tpu_torch.models import FiT, FiTLwD
from fitv2_tpu_torch.sample import SamplingConfig, build_sampler

from test_torch_port_int8_lwd import jax_tree
from test_torch_port_lwd import rel_l2

TOL_MAPS = 1e-5
TOL_NUMPY = 1e-6
TOL_REL = 1e-5
B = 2
SMALL = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
             depth=2, num_heads=2, learn_sigma=False, use_sit=True,
             use_swiglu=True, adaln_type='lora', adaln_lora_dim=16,
             num_classes=10, max_cached_len=8)
QK_LN = dict(q_norm='layernorm', k_norm='layernorm')
NORMS = {'qk_ln': QK_LN, 'none': {}}  # K2 + K4, and K3 on the card
BUCKETS = {'full': (4, 4), 'padded': (3, 4)}  # 16 and 12 of 16 tokens
NO_OPT = {'xla_backend_optimization_level': 0}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n_h, n_w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 16, 16)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    y = np.array([3, 10])  # a class and the null class
    g, m, s = (np.asarray(a) for a in j_grid(B, n_h, n_w, 16))
    return x, t, y, g, None if n_h * n_w == 16 else m, s


def _torch(arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _fit_pair(kw, seed=0):
    """(JAX FiT, params, port FiT with the same weights): every leaf
    N(0, 0.05), the tree laid out from the port model (no traced init)."""
    jm, pm = JFiT(**kw), FiT(**kw)
    params = jax_tree(pm, seed)
    pm.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), depth=kw['depth'],
        num_heads=kw['num_heads'], adaln_type=kw['adaln_type'],
        rope_layout=pm.rope_layout))
    return jm, params, pm.eval()


@pytest.fixture(scope='module')
def capture_models():
    """{(scan_blocks, norm): (JAX model, params, port model)}, each built
    with save_attention."""
    return {(scan, norm): _fit_pair(dict(SMALL, **NORMS[norm],
                                         scan_blocks=scan,
                                         save_attention=True))
            for scan in (True, False) for norm in NORMS}


@pytest.mark.parametrize('bucket', list(BUCKETS))
@pytest.mark.parametrize('norm', list(NORMS))
@pytest.mark.parametrize('scan', [True, False])
def test_captured_maps_match_jax(capture_models, scan, norm, bucket):
    jm, params, pm = capture_models[(scan, norm)]
    arrays = _inputs(*BUCKETS[bucket])
    # JAX's run_with_attention, its apply under one jit
    ref_out, mods = jax.jit(
        lambda p, *a: jm.apply({'params': p}, *a, mutable=['intermediates']),
        compiler_options=NO_OPT)(params, *arrays)
    ref_maps = jviz.collect_attention_maps(mods['intermediates'])
    out, maps = viz.run_with_attention(pm, *_torch(arrays))
    assert len(maps) == len(ref_maps) == SMALL['depth']
    for got, want in zip(maps, ref_maps):
        assert got.shape == (B, 2, 16, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=TOL_MAPS)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    if arrays[4] is not None:  # padded keys get no weight
        assert not np.concatenate(maps)[..., 12:].any()
    assert rel_l2(out, ref_out) <= TOL_REL


def test_capture_adds_work_and_replaces_none(capture_models):
    """save_attention changes no output, and maps of an earlier forward are
    cleared (one set a forward, in block order)."""
    jm, params, pm = capture_models[(False, 'qk_ln')]
    plain = FiT(**dict(SMALL, **QK_LN)).eval()
    plain.load_state_dict(pm.state_dict())
    arrays = _torch(_inputs(3, 4))
    out, maps = viz.run_with_attention(pm, *arrays)
    with torch.no_grad():
        assert torch.equal(out, plain(*arrays))
    _, again = viz.run_with_attention(pm, *arrays)
    assert len(again) == SMALL['depth']
    assert all(np.array_equal(a, b) for a, b in zip(maps, again))
    with pytest.raises(ValueError, match='save_attention'):
        viz.collect_attention_maps(plain)


@pytest.mark.parametrize('head_fusion,discard', [('mean', 0.0),
                                                 ('max', 0.25),
                                                 ('min', 0.5)])
def test_rollout_and_heatmap_match_jax(head_fusion, discard):
    rng = np.random.default_rng(1)
    maps = [rng.dirichlet(np.ones(16), size=(B, 2, 16)).astype(np.float32)
            for _ in range(3)]
    ours = viz.attention_rollout(maps, head_fusion, discard)
    theirs = jviz.attention_rollout(maps, head_fusion, discard)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL_NUMPY)
    for q in (0, 5):
        np.testing.assert_allclose(
            viz.token_heatmap(ours, (3, 4), q),
            jviz.token_heatmap(theirs, (3, 4), q), rtol=0, atol=TOL_NUMPY)
    with pytest.raises(ValueError):
        viz.attention_rollout(maps, 'median')


@pytest.mark.parametrize('heat_hw,image_hw', [((4, 4), (64, 64)),
                                              ((3, 5), (48, 37)),
                                              ((16, 16), (6, 10))])
def test_overlay_matches_jax_up_and_down(heat_hw, image_hw):
    rng = np.random.default_rng(2)
    heat = rng.uniform(size=heat_hw).astype(np.float32)
    image = rng.integers(0, 256, size=(*image_hw, 3), dtype=np.uint8)
    ours = viz.overlay_heatmap(image, heat, alpha=0.6)
    theirs = jviz.overlay_heatmap(image, heat, alpha=0.6)
    assert ours.shape == theirs.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1


def test_rel_pe_on_v_fit_matches_jax():
    kw = dict(SMALL, **QK_LN, add_rel_pe_to_v=True)
    jm, params, pm = _fit_pair(kw, seed=3)
    # JAX forces the interleaved layout on the attention and the tables
    assert pm.rope_layout == 'interleaved'
    assert pm.rope_config.layout == 'interleaved'
    assert not pm.blocks[0].attn.fuse_qk
    arrays = _inputs(3, 4, seed=4)
    ref = jax.jit(lambda p, *a: jm.apply({'params': p}, *a),
                  compiler_options=NO_OPT)(params, *arrays)
    with torch.no_grad():
        out = pm(*_torch(arrays))
    assert rel_l2(out, ref) <= TOL_REL
    # v's rotation is live: the same weights without it differ
    other = FiT(**dict(SMALL, **QK_LN, rope_layout='interleaved')).eval()
    other.load_state_dict(pm.state_dict())
    with torch.no_grad():
        assert rel_l2(other(*_torch(arrays)), ref) > 1e-3


def test_rel_pe_on_v_fitlwd_matches_jax():
    kw = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
              depth=4, num_heads=4, num_classes=10, number_of_perflow=2,
              n_patch_h=4, n_patch_w=4, adaln_type='lora',
              adaln_lora_dim=16, max_cached_len=8, add_rel_pe_to_v=True,
              **QK_LN)
    jm, pm = JFiTLwD(**kw), FiTLwD(**kw)
    assert pm.rope_config.layout == 'interleaved'
    params = jax_tree(pm, seed=5)
    pm.load_state_dict(lwd_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pm), strict=True)
    x, t, y, g, m, s = _inputs(3, 4, seed=6)
    m = np.asarray(j_grid(B, 3, 4, 16)[1])
    ref, _ = jax.jit(lambda p, *a: jm.apply(
        {'params': p}, *a[:3], 1, *a[3:], method=jm.forward_run_layer),
        compiler_options=NO_OPT)(params, x, t, y, g, m, s)
    with torch.no_grad():
        out, _ = pm.eval().forward_run_layer(*_torch((x, t, y)), 1,
                                             *_torch((g, m, s)))
    assert rel_l2(out, ref) <= TOL_REL


@pytest.fixture(scope='module')
def traj_models():
    return _fit_pair(dict(SMALL, **QK_LN), seed=7)


def test_trajectory_matches_jax(traj_models):
    jm, params, pm = traj_models
    kw = dict(image_height=48, image_width=64, num_sampling_steps=4,
              num_classes=10, per_device_batch=B)
    rng, labels = jax.random.PRNGKey(2), np.array([1, 7])
    ref_out, ref_traj = j_build_sampler(
        jm, params, JSamplingConfig(dtype=jnp.float32, **kw),
        return_trajectory=True)(rng, jnp.asarray(labels))
    z = np.array(jax.random.normal(rng, (B, 16, 16), jnp.float32))
    fn = build_sampler(pm, SamplingConfig(dtype=torch.float32, **kw),
                       return_trajectory=True)
    out, traj = fn(torch.from_numpy(labels), z=torch.from_numpy(z))
    assert traj.shape == (4, B, 16, 16) and traj.dtype == torch.float32
    for step in range(4):
        assert rel_l2(traj[step], ref_traj[step]) <= TOL_REL
    assert rel_l2(out, ref_out) <= TOL_REL
    # the last step's state is the one decoded, bit for bit
    assert torch.equal(pm.unpatchify(traj[-1][:, :12], (6, 8))[:, :4], out)
    plain = build_sampler(pm, SamplingConfig(dtype=torch.float32, **kw))
    assert torch.equal(plain(torch.from_numpy(labels),
                             z=torch.from_numpy(z)), out)


@pytest.mark.parametrize('options', [
    dict(velocity_eval_every=2), dict(guidance_low=0.3, guidance_high=0.9),
    dict(sampler_mode='ddim')])
def test_trajectory_refusals_match_jax(traj_models, options):
    jm, params, pm = traj_models
    cfg = dict(image_height=32, image_width=32, num_sampling_steps=4,
               num_classes=10, per_device_batch=B, **options)
    with pytest.raises(ValueError) as theirs:
        j_build_sampler(jm, params, JSamplingConfig(**cfg),
                        return_trajectory=True)
    with pytest.raises(ValueError) as ours:
        build_sampler(pm, SamplingConfig(**cfg), return_trajectory=True)
    assert str(ours.value) == str(theirs.value)


def test_cli_visualize_attention_writes_its_file(tmp_path):
    path = cli.main(['--device', 'cpu', '--out', str(tmp_path), '--query',
                     '3'])
    assert os.path.basename(path).startswith('rollout_q3.')
    over = (np.load(path) if path.endswith('.npy')
            else np.asarray(__import__('PIL.Image').Image.open(path)))
    assert over.shape == (128, 128, 3) and over.dtype == np.uint8
    assert over[..., 0].max() > 64  # the heat is there
