"""PyTorch port, item 20b: int8 W8A8 serving of the LwD family (FiTLwD and
the shared-encoder model with ``gemm_precision='int8'``, calibrated through
``init_all``) and per-bucket int8 state in ``BucketedSampler``, against the
JAX package on the same weights and numpy inputs.

JAX's ``quant_calib`` / ``quant_weights`` collections cross over with
``ckpt.lwd_quant_state_from_jax`` (the LwD block stacks) and
``ckpt.quant_state_from_jax`` (a FiT bucket's). JAX's calibration drops
labels with its ``label_dropout`` key (class dropout 0.5 here); the tests
read the drops back from JAX's label embedder outputs and hand them to the
port's ``init_all``.

Tolerances, fp32 on both sides (test_torch_port_int8's reasoning: ~1e-7
upstream differences move an activation across an int8 rounding boundary
now and then, and one flip moves its GEMM row by one quantization step):
- the dynamic and calibrated LwD samplers: relative L2 4e-3;
- the calibrated scales: 1e-3 relative a site (a flip upstream of a site
  moves its absmax by at most one step of the producing GEMM);
- the int8 FiT buckets, 3 Euler steps: relative L2 5e-3;
- a bucket's sampler run again after another bucket's, and against a
  sampler of that bucket alone: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.fit_lwd_sharedenc import (
    FiTLwDSharedEncSepDec as JShared)
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.ops import quant as jquant
from fitv2_tpu.sample import BucketedSampler as JBucketedSampler
from fitv2_tpu.sample import SamplingConfig as JSamplingConfig

from fitv2_tpu_torch.ckpt import (
    jax_leaves, lwd_quant_state_from_jax, lwd_state_from_jax,
    quant_state_from_jax, state_dict_from_jax)
from fitv2_tpu_torch.kernels import quant as pquant
from fitv2_tpu_torch.models import FiT, FiTLwD, FiTLwDSharedEncSepDec
from fitv2_tpu_torch.sample import BucketedSampler, SamplingConfig

from test_torch_port_lwd import SMALL, rel_l2

NO_OPT = {'xla_backend_optimization_level': 0}
TOL_SAMPLER = 4e-3
TOL_SCALE = 1e-3
TOL_BUCKET = 5e-3
INT8 = dict(SMALL, depth=2, gemm_precision='int8', class_dropout_prob=0.5)
B = 4  # x 16 tokens = 64 GEMM rows (2 x 64 under CFG)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_tree(pm, seed, scale=0.05):
    """JAX's parameter tree for the port's model ``pm`` (its paths and
    layout from ``ckpt.jax_leaves``: no traced init), every leaf N(0,
    scale) from ``seed`` (adaLN-zero would make every output 0)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for leaf in jax_leaves(pm):
        shape = leaf.to_jax([p.detach() for n, p in pm.named_parameters()
                             if n in leaf.names]).shape
        node = tree
        *heads, last = leaf.path.split('/')
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(rng.standard_normal(shape).astype(
            np.float32) * scale)
    return tree


def jax_and_port(jm, pm, seed):
    params = jax_tree(pm, seed)
    pm.load_state_dict(lwd_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pm), strict=True)
    return jm, params, pm.eval()


@pytest.fixture(scope='module')
def lwd_models():
    """{name: (JAX model, randomised params, port model)}: int8 FiTLwD and
    the shared-encoder model."""
    return {
        'fitlwd': jax_and_port(JFiTLwD(**INT8), FiTLwD(**INT8), seed=7),
        'sharedenc': jax_and_port(
            JShared(**INT8, number_of_representation_blocks=1, repa_dim=16),
            FiTLwDSharedEncSepDec(**INT8, number_of_representation_blocks=1,
                                  repa_dim=16), seed=8)}


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 16, 16)).astype(np.float32)
    y = np.array([3, 7, 1, 9])
    return x, y


def _calib_args():
    rng = np.random.default_rng(4)
    g, m, s = j_grid(B, 4, 4, 16)
    return (rng.standard_normal((B, 16, 16)).astype(np.float32),
            np.full((B,), 0.5, np.float32), np.array([2, 5, 8, 0]),
            np.asarray(g), np.asarray(m), np.asarray(s))


def _jax_calibration(jm, params, key):
    """JAX's calibration pass (``init_all`` with the drop key, the one
    apply of ``calibrate_quant_scales``, which also prequantizes the
    weights when ``quant_weights`` is mutable, as ``prequantize_weights``
    does) under one jit: (its collections, the label drops it took at each
    segment, read off the label embedder's outputs: == the null row)."""
    args = tuple(map(jnp.asarray, _calib_args()))

    def run(p):
        _, st = jm.apply(
            {'params': p}, *args, rngs={'label_dropout': key},
            capture_intermediates=lambda m, _: (
                m.name or '').startswith('y_embedders'),
            mutable=['intermediates', 'quant_calib', 'quant_weights'])
        null = p['y_embedders_0']['embedding_table'][jm.num_classes]
        outs = st['intermediates']['y_embedders_0']['__call__']
        drops = [jnp.all(o == null, axis=-1)
                 for o in outs[:jm.number_of_perflow]]
        return {k: st[k] for k in ('quant_calib', 'quant_weights')}, drops
    coll, drops = jax.device_get(
        jax.jit(run, compiler_options=NO_OPT)(params))
    return coll, [torch.from_numpy(np.asarray(d, np.int64)) for d in drops]


def _sample(jm, params, coll, x, y, cfg_scale=None):
    variables = {'params': params, **(coll or {})}
    if cfg_scale is None:
        fn = jax.jit(lambda v, x, y: jm.apply(v, x, y, 1, method=jm.sample),
                     compiler_options=NO_OPT)
        return np.asarray(fn(variables, x, y))
    fn = jax.jit(lambda v, x, y: jm.apply(v, x, y, cfg_scale, 1,
                                          method=jm.sample_cfg),
                 compiler_options=NO_OPT)
    return np.asarray(fn(variables, x, y))


@pytest.mark.parametrize('name', ['fitlwd', 'sharedenc'])
def test_int8_lwd_dynamic_sampler_matches_jax(lwd_models, name):
    """Uncalibrated: every block GEMM runs the dynamic per-row mode."""
    jm, params, pm = lwd_models[name]
    pquant.load_quant_state(pm, {f'{n}.{b}': None for n in
                                 pquant.int8_layers(pm)
                                 for b in pquant.QUANT_BUFFERS})
    x, y = _inputs()
    want = _sample(jm, params, None, x, y)
    got = pm.sample(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_l2(got, want) <= TOL_SAMPLER
    n_layers = len(pquant.int8_layers(pm))
    assert n_layers == 4 * (pm.depth + (name == 'sharedenc') * 2)


@pytest.mark.parametrize('name', ['fitlwd', 'sharedenc'])
def test_int8_lwd_calibrated_matches_jax(lwd_models, name):
    """JAX's collections carried across: ``sample`` and ``sample_cfg``
    through the serving GEMMs; then the port's own calibration on the same
    inputs and drops gives JAX's scales."""
    jm, params, pm = lwd_models[name]
    coll, drops = _jax_calibration(jm, params, jax.random.PRNGKey(21))
    state = lwd_quant_state_from_jax(coll)
    layers = pquant.int8_layers(pm)
    assert set(state) == {f'{n}.{b}' for n in layers
                          for b in pquant.QUANT_BUFFERS}
    pquant.load_quant_state(pm, state)
    assert all(m.quant_parts() is not None for m in layers.values())
    x, y = _inputs()
    # the shared-encoder model: sample only (its sample_cfg runs the same
    # serving GEMMs), to save a compile
    for cfg_scale in (None, 1.5) if name == 'fitlwd' else (None,):
        want = _sample(jm, params, coll, x, y, cfg_scale)
        got = (pm.sample(torch.from_numpy(x), torch.from_numpy(y))
               if cfg_scale is None else
               pm.sample_cfg(torch.from_numpy(x), torch.from_numpy(y),
                             cfg_scale)).numpy()
        assert rel_l2(got, want) <= TOL_SAMPLER, cfg_scale

    assert 0 < int(torch.stack(drops).sum()) < B * len(drops)
    xc, tc, yc, g, m, s = (torch.from_numpy(a.copy()) for a in _calib_args())
    mine = pquant.calibrate_quant_scales(
        pm, [(xc, tc, yc, g, None, s, drops)])
    for k, v in mine.items():
        ref = state[k]
        assert abs(float(v) - float(ref)) <= TOL_SCALE * float(ref), k
    # the segments' stacks, the trunk and the mid blocks all calibrated
    assert all(v is not None and float(v) > 0 for v in mine.values())


# -- per-bucket int8 state ----------------------------------------------------

FIT8 = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
            depth=2, num_heads=4, learn_sigma=False, use_sit=True,
            use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
            adaln_type='lora', adaln_lora_dim=16, num_classes=10,
            max_cached_len=16, gemm_precision='int8')
BUCKET_A, BUCKET_B = (64, 64), (96, 96)  # 4 x 4 tokens, then 6 x 6 (dynntk)
BASE = dict(num_sampling_steps=3, cfg_scale=1.5, num_classes=10,
            per_device_batch=2)


@pytest.fixture(scope='module')
def fit8():
    """The int8 FiT in both packages (every leaf randomised)."""
    jm = JFiT(**FIT8)
    params = jax_tree(FiT(**FIT8), seed=9)
    pnp = jax.tree_util.tree_map(np.asarray, params)

    def port():
        pm = FiT(**FIT8)
        pm.load_state_dict(state_dict_from_jax(
            pnp, depth=2, num_heads=4, adaln_type='lora'))
        return pm.eval()
    return jm, params, port


def test_int8_buckets_match_jax(fit8, monkeypatch):
    """JAX's BucketedSampler calibrates each bucket's sampler; its
    collections, recorded as they are made and carried across, serve the
    port's bucket samplers, which match JAX at each bucket, in the order
    A, B, A."""
    jm, params, port = fit8
    made = []
    calib, prequant = jquant.calibrate_quant_scales, \
        jquant.prequantize_weights

    def calibrate(model, p, batches):  # JAX's, recorded, under one jit
        made.append({'quant_calib': jax.jit(
            lambda p, b: calib(model, p, b),
            compiler_options=NO_OPT)(p, batches)})
        return made[-1]['quant_calib']

    def prequantize(model, p, args):
        made[-1]['quant_weights'] = jax.jit(
            lambda p, a: prequant(model, p, a),
            compiler_options=NO_OPT)(p, args)
        return made[-1]['quant_weights']
    monkeypatch.setattr(jquant, 'calibrate_quant_scales', calibrate)
    monkeypatch.setattr(jquant, 'prequantize_weights', prequantize)
    jb = JBucketedSampler(jm, params, JSamplingConfig(dtype=jnp.float32,
                                                      **BASE),
                          ori_max_pe_len=4)
    labels = np.array([1, 7])
    rng = jax.random.PRNGKey(5)
    want, colls = {}, {}
    for hw in (BUCKET_A, BUCKET_B):
        want[hw] = np.asarray(jb.sample(rng, jnp.asarray(labels), *hw))
        colls[hw] = quant_state_from_jax(jax.device_get(made[-1]), depth=2)
    assert len(made) == 2
    # each bucket has its own scales
    assert any(not torch.equal(v, colls[BUCKET_B][k])
               for k, v in colls[BUCKET_A].items() if 'act_absmax' in k)

    pb = BucketedSampler(port(), SamplingConfig(dtype=torch.float32, **BASE),
                         ori_max_pe_len=4, quant_collections=colls)
    got = []
    for hw in (BUCKET_A, BUCKET_B, BUCKET_A):
        n = (hw[0] // 16) * (hw[1] // 16)
        z = np.array(jax.random.normal(rng, (2, max(16, n), 16)))
        got.append(pb.sample(torch.from_numpy(labels), *hw,
                             z=torch.from_numpy(z)).numpy())
        assert rel_l2(got[-1], want[hw]) <= TOL_BUCKET, hw
    assert np.array_equal(got[0], got[2])


def test_int8_bucket_order_is_bit_identical(fit8):
    """The port's own per-bucket calibration: A, B, A equals a sampler of
    A alone bit for bit; both buckets share one set of int8 weights, and
    each keeps its own scales."""
    _, _, port = fit8
    cfg = SamplingConfig(dtype=torch.float32, **BASE)
    labels = torch.tensor([2, 5])
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    alone = BucketedSampler(port(), cfg, ori_max_pe_len=4).sample(
        labels, *BUCKET_A, generator=gen())
    pm = port()
    pb = BucketedSampler(pm, cfg, ori_max_pe_len=4)
    first = pb.sample(labels, *BUCKET_A, generator=gen())
    layer = pm.blocks[0].attn.qkv
    w_q, scale_a = layer.weight_q, layer.act_absmax
    other = pb.sample(labels, *BUCKET_B, generator=gen())
    assert layer.weight_q is w_q  # quantized once, shared
    scales_b = [float(m.act_absmax)
                for m in pquant.int8_layers(pm).values()]
    again = pb.sample(labels, *BUCKET_A, generator=gen())
    assert layer.act_absmax is scale_a
    scales_a = [float(m.act_absmax)
                for m in pquant.int8_layers(pm).values()]
    assert scales_a != scales_b
    assert torch.equal(first, alone) and torch.equal(again, alone)
    assert other.shape != first.shape and torch.isfinite(other).all()
