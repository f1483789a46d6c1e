"""PyTorch port, resolution-flexible sampling (fitv2_tpu_torch.models.rope,
models.fit with online RoPE, sample.pipeline's interpolation modes,
sample.buckets, cli.sample on the HR config) against the JAX package.

The same numpy inputs, and JAX params carried across with
``state_dict_from_jax`` (zero-init leaves perturbed), go through both
packages; the sampler's noise is JAX's own draw, handed to the port as
``z``. Tolerances:
  - RoPE tables, online and interpolated: 1e-6 abs (fp32 cos/sin of the
    same float32 angles; measured <= 3e-7);
  - the FiT forward and 4-step samplers: relative L2 1e-5 in fp32 (the two
    frameworks sum in another order).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from fitv2_tpu.ckpt.torch_export import export_fit_state_dict, save_safetensors
from fitv2_tpu.models import grid_utils as jgrid
from fitv2_tpu.models import rope as jrope
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.sample import STANDARD_BUCKETS as J_STANDARD_BUCKETS
from fitv2_tpu.sample import BucketedSampler as JBucketedSampler
from fitv2_tpu.sample import SamplingConfig as JSamplingConfig
from fitv2_tpu.sample import apply_rope_interpolation as j_apply
from fitv2_tpu.sample import build_sampler as j_build_sampler

from fitv2_tpu_torch.ckpt import state_dict_from_jax
from fitv2_tpu_torch.cli import sample as cli
from fitv2_tpu_torch.models import FiT, rope
from fitv2_tpu_torch.sample import (
    INTERPOLATION_MODES, STANDARD_BUCKETS, BucketedSampler, SamplingConfig,
    apply_rope_interpolation, build_sampler, generate_fid_samples)
from fitv2_tpu_torch.utils import config_to_model, load_config

TOL_TABLE = 1e-6
TOL_REL_L2 = 1e-5
MODES = ['normal', 'linear', 'ntk-aware', 'ntk-aware-pro1', 'ntk-aware-pro2',
         'ntk-by-parts', 'yarn']
# (h, w) token grids, unequal and non-square: a swap of h and w shows
SIZES = [(8, 8), (4, 12), (32, 32), (20, 40)]
# a small online-NTK FiTv2: online decoupled NTK trained at a 4 x 4 grid
SMALL_HR = dict(context_size=64, patch_size=2, in_channels=4, hidden_size=64,
                depth=2, num_heads=4, learn_sigma=False, use_sit=True,
                use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
                adaln_type='lora', adaln_lora_dim=16, num_classes=10,
                online_rope=True, custom_freqs='ntk-aware', decouple=True,
                ori_max_pe_len=4, max_cached_len=64)
# the same, trained with cached normal RoPE at 16 tokens (4 x 4)
SMALL = dict(SMALL_HR, context_size=16, online_rope=False,
             custom_freqs='normal', decouple=False, ori_max_pe_len=None,
             max_cached_len=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def padded_grids(sizes, n_ctx):
    """Per-sample grid (B, 2, n_ctx), mask (B, n_ctx), size (B, 1, 2)."""
    grid = np.zeros((len(sizes), 2, n_ctx), np.int32)
    mask = np.zeros((len(sizes), n_ctx), np.float32)
    for i, (h, w) in enumerate(sizes):
        grid[i, :, :h * w] = jgrid.make_grid(h, w)
        mask[i, :h * w] = 1.0
    size = np.array(sizes, np.int32).reshape(len(sizes), 1, 2)
    return grid, mask, size


def perturbed(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)

    def f(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + scale * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def jax_and_port(kw, layout='split'):
    """JAX FiT + params and the port FiT holding the same weights."""
    kw = dict(kw, rope_layout=layout)
    jm = JFiT(**kw)
    n = kw['context_size']
    g, m, s = jgrid.make_grid_mask_size(1, 4, 4, n)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, n, 16)),
                              jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
                              g, m, s)['params']
    params = perturbed(params)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    pm = FiT(**kw)
    pm.load_state_dict(state_dict_from_jax(
        pnp, depth=kw['depth'], num_heads=kw['num_heads'],
        adaln_type=kw['adaln_type'], rope_layout=layout))
    return jm, params, pm.eval(), pnp


@pytest.fixture(scope='module')
def hr_models():
    return jax_and_port(SMALL_HR)


@pytest.fixture(scope='module')
def small_models():
    return jax_and_port(SMALL)


# -- RoPE ----------------------------------------------------------------------

@pytest.mark.parametrize('layout', ['split', 'interleaved'])
@pytest.mark.parametrize('mode', MODES)
def test_online_rope_tables_match_jax(mode, layout):
    grid, _, size = padded_grids(SIZES, 1024)
    for decouple in (True, False):
        kw = dict(head_dim=72, mode=mode, ori_max_pe_len=16,
                  decouple=decouple, layout=layout, online=True)
        want = jrope.online_rope_from_grid(
            jrope.RopeConfig(**kw), jnp.asarray(grid), jnp.asarray(size))
        got = rope.online_rope_from_grid(
            rope.RopeConfig(**kw), torch.from_numpy(grid).long(),
            torch.from_numpy(size).long())
        for g, w in zip(got, want):
            assert g.shape == (len(SIZES), 1024, 72)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=TOL_TABLE)
    if mode != 'normal':  # decoupled, (h, w) and (w, h) give other tables
        kw['decouple'] = True
        got, swapped = (rope.online_rope_from_grid(
            rope.RopeConfig(**kw), torch.from_numpy(grid).long(),
            torch.from_numpy(sz).long()) for sz in (size,
                                                    size[..., ::-1].copy()))
        assert not torch.allclose(swapped[0][3], got[0][3])


@pytest.mark.parametrize('layout', ['split', 'interleaved'])
@pytest.mark.parametrize('interpolation', sorted(INTERPOLATION_MODES))
def test_interpolated_tables_match_jax(interpolation, layout):
    """The tables each mode samples a bucket with, as
    apply_rope_interpolation sets them, gathered at the bucket's grid."""
    kw = dict(SMALL_HR if interpolation == 'keep' else SMALL,
              max_cached_len=16, rope_layout=layout)
    jm, pm = JFiT(**kw), FiT(**kw)
    for hw in ((160, 320), (320, 320), (512, 512), (320, 640)):
        scfg = dict(image_height=hw[0], image_width=hw[1],
                    interpolation=interpolation, ori_max_pe_len=16,
                    decouple=True)
        rc = apply_rope_interpolation(pm, SamplingConfig(**scfg))
        jclone = j_apply(jm, JSamplingConfig(**scfg))
        assert rc.online == jclone.online_rope
        n_h, n_w = hw[0] // 16, hw[1] // 16
        g, _, s = jgrid.make_grid_mask_size(2, n_h, n_w, n_h * n_w)
        if interpolation == 'no':  # normal tables, long enough for the grid
            rc = dataclasses.replace(rc, max_cached_len=max(n_h, n_w))
            jclone = jclone.clone(max_cached_len=max(n_h, n_w))
        want = jclone._rope(g, s)
        got = pm.rope(torch.tensor(np.asarray(g)).long(),
                      torch.tensor(np.asarray(s)).long(), config=rc)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL_TABLE)


def test_rope_21d_matches_jax():
    cfg = dict(head_dim=72, max_cached_len=40)
    wh = jgrid.make_grid(5, 6)  # 30 tokens of 3 frames
    grid = np.stack([np.concatenate([wh, np.arange(30)[None] % 3]),
                     np.concatenate([wh[::-1], np.arange(30)[None] // 10])]
                    ).astype(np.int32)
    for layout in ('split', 'interleaved'):
        c = dict(cfg, layout=layout)
        want = jrope.rope_21d_from_grid(
            jrope.build_rope_cache(jrope.RopeConfig(**c)), jnp.asarray(grid),
            layout)
        got = rope.rope_21d_from_grid(
            rope.build_rope_cache(rope.RopeConfig(**c)),
            torch.from_numpy(grid).long(), layout)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL_TABLE)


def test_rope_cache_is_keyed_on_the_whole_config():
    """Two buckets with one mode but another max_pe_len get their own
    tables."""
    pm = FiT(**SMALL)
    g = torch.tensor(jgrid.make_grid(4, 4))[None].long()
    a = dataclasses.replace(pm.rope_config, mode='ntk-aware',
                            max_pe_len_h=8, max_pe_len_w=8, ori_max_pe_len=4)
    b = dataclasses.replace(a, max_pe_len_h=16, max_pe_len_w=16)
    ca, cb = pm.rope(g, config=a)[0], pm.rope(g, config=b)[0]
    assert not torch.allclose(ca, cb)
    assert torch.equal(pm.rope(g, config=a)[0], ca)
    with pytest.raises(ValueError, match='size'):
        pm.rope(g, config=dataclasses.replace(a, online=True))


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize('layout', ['split', 'interleaved'])
def test_online_rope_forward_matches_jax(layout):
    """Batch 2 with token grids 8 x 8 and 4 x 12 on a 64-token context,
    masked, online decoupled NTK trained at 4 x 4."""
    jm, params, pm, _ = jax_and_port(SMALL_HR, layout)
    grid, mask, size = padded_grids([(8, 8), (4, 12)], 64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    y = np.array([3, 10])
    want = np.asarray(jax.jit(jm.apply)(
        {'params': params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
        jnp.asarray(grid), jnp.asarray(mask), jnp.asarray(size)))
    args = [torch.from_numpy(a) for a in (x, t, y)]
    g, m, s = (torch.from_numpy(grid).long(), torch.from_numpy(mask),
               torch.from_numpy(size).long())
    with torch.no_grad():
        got = pm(*args, g, m, s).numpy()
        cached = pm(*args, g, m, s, rope=pm.rope(
            g, s, config=dataclasses.replace(
                pm.rope_config, online=False, max_pe_len_h=8,
                max_pe_len_w=12))).numpy()
    assert rel_l2(got, want) <= TOL_REL_L2
    # the per-sample frequencies matter: one sample's cached ntk tables
    # (h scaled to 8 where the sample has 4) move the output by far more
    # than the tolerance
    assert rel_l2(cached, want) > 10 * TOL_REL_L2
    with pytest.raises(ValueError, match='size'):
        pm(*args, g, m)


# -- the sampler and the buckets -----------------------------------------------

def test_bucketed_extrapolated_sampler_matches_jax(small_models):
    """dynntk on a 6 x 6 bucket: the context grows from 16 to 36 tokens."""
    jm, params, pm, _ = small_models
    base = dict(num_sampling_steps=4, cfg_scale=1.5, num_classes=10,
                per_device_batch=2)
    jb = JBucketedSampler(jm, params, JSamplingConfig(dtype=jnp.float32,
                                                      **base),
                          ori_max_pe_len=4)
    pb = BucketedSampler(pm, SamplingConfig(dtype=torch.float32, **base),
                         ori_max_pe_len=4)
    rng = jax.random.PRNGKey(5)
    labels = np.array([1, 7])
    want = np.asarray(jb.sample(rng, jnp.asarray(labels), 96, 96, 'dynntk'))
    z = np.array(jax.random.normal(rng, (2, 36, 16), jnp.float32))
    got = pb.sample(torch.from_numpy(labels), 96, 96, 'dynntk',
                    z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 4, 12, 12)
    assert rel_l2(got, want) <= TOL_REL_L2
    # normal frequencies on the same bucket give another sample
    plain = pb.sample(torch.from_numpy(labels), 96, 96, 'no',
                      z=torch.from_numpy(z)).numpy()
    assert rel_l2(plain, want) > 1e-4


@pytest.mark.parametrize('pixels', [(128, 128), (64, 192)],
                         ids=['full_8x8', 'padded_4x12'])
def test_keep_sampler_matches_jax(hr_models, pixels):
    """'keep' samples with the model's online decoupled NTK."""
    jm, params, pm, _ = hr_models
    h, w = pixels
    kw = dict(image_height=h, image_width=w, num_sampling_steps=4,
              cfg_scale=1.5, num_classes=10, per_device_batch=2,
              interpolation='keep')
    jfn = j_build_sampler(jm, params, JSamplingConfig(dtype=jnp.float32,
                                                       **kw))
    rng = jax.random.PRNGKey(9)
    labels = np.array([4, 2])
    want = np.asarray(jfn(rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (2, 64, 16), jnp.float32))
    got = build_sampler(pm, SamplingConfig(dtype=torch.float32, **kw))(
        torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 4, h // 8, w // 8)
    assert rel_l2(got, want) <= TOL_REL_L2


def test_bucket_configs_match_jax(small_models):
    jm, params, pm, _ = small_models
    jb = JBucketedSampler(jm, params, JSamplingConfig(), ori_max_pe_len=16)
    pb = BucketedSampler(pm, SamplingConfig(), ori_max_pe_len=16)
    assert STANDARD_BUCKETS == J_STANDARD_BUCKETS
    fields = ('image_height', 'image_width', 'interpolation',
              'ori_max_pe_len', 'decouple', 'num_sampling_steps',
              'cfg_scale')
    sizes = list(STANDARD_BUCKETS) + [(128, 128), (256, 384), (64, 512),
                                      (272, 256), (256, 272)]
    for hw in sizes:
        for interp in (None, 'no', 'yarn', 'partntk'):
            a, b = pb.config_for(*hw, interp), jb.config_for(*hw, interp)
            assert [getattr(a, f) for f in fields] == \
                [getattr(b, f) for f in fields], (hw, interp)


def test_bucket_cache_keys_on_the_interpolation(small_models):
    """The port builds a sampler per explicit interpolation; JAX's cache key
    leaves it out and hands back the first mode's sampler
    (reference-side)."""
    jm, params, pm, _ = small_models
    jb = JBucketedSampler(jm, params, JSamplingConfig(), ori_max_pe_len=4)
    pb = BucketedSampler(pm, SamplingConfig(num_classes=10),
                         ori_max_pe_len=4)
    assert jb.get(96, 96) is jb.get(96, 96, 'yarn')
    first = pb.get(96, 96)
    assert pb.get(96, 96, 'yarn') is not first
    assert pb.get(96, 96) is first and pb.get(96, 96, 'dynntk') is first
    # an int8 model's buckets too (each calibrates its own scales; the
    # per-bucket parity is test_torch_port_int8_lwd.py)
    ib = BucketedSampler(FiT(**dict(SMALL, gemm_precision='int8')),
                         SamplingConfig(num_classes=10, num_sampling_steps=2,
                                        per_device_batch=2),
                         ori_max_pe_len=4)
    assert ib.get(96, 96, 'yarn') is not ib.get(96, 96)


# -- the configs and the CLI ---------------------------------------------------

@pytest.mark.parametrize('name', ['fitv2_hr_xl', 'fitv2_hr_3b'])
def test_hr_configs_build_with_online_rope(name):
    cfg = load_config(os.path.join(REPO, 'configs', f'{name}.yaml'))
    model = config_to_model(cfg['diffusion']['network_config'], depth=1)
    rc = model.rope_config
    assert model.context_size == 1024
    assert (rc.online, rc.mode, rc.decouple, rc.ori_max_pe_len) == \
        (True, 'ntk-aware', True, 16)


def test_cli_samples_the_hr_config_on_cpu(tmp_path):
    """configs/fitv2_hr_xl.yaml, cut to depth 1 and hidden 64 by a second
    config file, through cli.sample with an interpolated bucket; against
    the same run through the library."""
    override = {'diffusion': {'network_config': {'params': dict(
        depth=1, hidden_size=64, num_heads=4, adaln_lora_dim=16,
        num_classes=10, context_size=64)}}}
    small_cfg = str(tmp_path / 'small.yaml')
    with open(small_cfg, 'w') as f:
        yaml.safe_dump(override, f)
    cfgdir = [os.path.join(REPO, 'configs', 'fitv2_hr_xl.yaml'), small_cfg]
    net = load_config(cfgdir)['diffusion']['network_config']
    jkw = {k: v for k, v in net['params'].items()
           if k not in ('use_checkpoint', 'remat_policy')}
    jm, _, pm, pnp = jax_and_port(dict(jkw, learn_sigma=False))
    assert pm.rope_config.online
    ckpt = str(tmp_path / 'hr.safetensors')
    save_safetensors(export_fit_state_dict(pnp, depth=1, adaln_type='lora',
                                           num_heads=4, rope_layout='split'),
                     ckpt)
    out = str(tmp_path / 'hr.npz')
    cli.main(['--cfgdir', *cfgdir, '--ckpt', ckpt, '--image-height', '128',
              '--image-width', '96', '--num-sampling-steps', '2',
              '--num-fid-samples', '3', '--per-device-batch', '2',
              '--num-classes', '10', '--interpolation', 'dynntk',
              '--decouple', '--ori-max-pe-len', '4', '--device', 'cpu',
              '--out', out])
    arr = np.load(out)['arr_0']
    assert arr.shape == (3, 4, 16, 12) and np.isfinite(arr).all()
    fn = build_sampler(pm, SamplingConfig(
        image_height=128, image_width=96, num_sampling_steps=2,
        num_classes=10, per_device_batch=2, interpolation='dynntk',
        decouple=True, ori_max_pe_len=4))
    np.testing.assert_allclose(
        arr, generate_fid_samples(fn, 3, 2, num_classes=10, seed=0),
        rtol=1e-6, atol=1e-6)
