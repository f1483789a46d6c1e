"""PyTorch port, item 24: the utilities -- ``utils/training_stats.py``,
``utils/misc.py``, ``utils/eval_args.py``, ``eval/measure.py`` and
``utils/config.py``'s ``get_obj_from_str`` / ``instantiate_from_config``
-- against the JAX package's, mirroring tests/test_utils.py,
tests/test_misc.py and tests/test_eval.py::test_measure_stats.

Tolerances: the moments and the collector's statistics 1e-6 relative
(float32 sums in other orders); the image statistics, the parameter
tables, the parsed flags and the FLOP count exactly (the same numpy or
integer arithmetic).
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fitv2_tpu.eval import measure as jmeasure
from fitv2_tpu.utils import eval_args as jeval_args
from fitv2_tpu.utils import instantiate_from_config as j_instantiate
from fitv2_tpu.utils import misc as jmisc
from fitv2_tpu.utils import training_stats as jstats

from fitv2_tpu_torch.eval import measure
from fitv2_tpu_torch.models import FiT, FiTLwD
from fitv2_tpu_torch.utils import (
    eval_args, get_obj_from_str, instantiate_from_config, misc,
    training_stats)
from fitv2_tpu_torch.utils.config import resolve_target

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


# -- config -------------------------------------------------------------------

def test_instantiate_from_config_builds_the_port_model():
    """The YAMLs' JAX targets build the port's counterpart, with the
    JAX model's hyperparameters; extra keyword arguments override."""
    cfg = {'target': 'fitv2_tpu.models.fit.FiT',
           'params': {'hidden_size': 64, 'depth': 2, 'num_heads': 4,
                      'context_size': 16}}
    ref = j_instantiate(cfg, depth=3)
    model = instantiate_from_config(cfg, depth=3)
    assert isinstance(model, FiT)
    assert (model.hidden_size, model.depth, model.num_heads,
            model.context_size) == (ref.hidden_size, ref.depth,
                                    ref.num_heads, ref.context_size)
    lwd = instantiate_from_config({
        'target': 'fit.model.fit_model_lwd.FiTLwD',
        'params': dict(hidden_size=32, depth=2, num_heads=2,
                       number_of_perflow=2, context_size=16,
                       adaln_lora_dim=8)})
    assert isinstance(lwd, FiTLwD)
    assert instantiate_from_config('__is_first_stage__') is None
    with pytest.raises(KeyError):
        instantiate_from_config({'params': {}})


def test_targets_resolve_to_the_port():
    from fitv2_tpu_torch.data.latent_dataset import INLatentLoader
    assert get_obj_from_str(
        'fitv2_tpu.data.latent_dataset.INLatentLoader') is INLatentLoader
    assert get_obj_from_str(
        'fit.data.in1k_latent_dataset.INLatentLoader') is INLatentLoader
    assert get_obj_from_str('fitv2_tpu.eval.measure.ssim') is measure.ssim
    assert get_obj_from_str('fitv2_tpu.models.bfm.BFM').__module__ == \
        'fitv2_tpu_torch.models.bfm'
    assert get_obj_from_str('collections.OrderedDict').__name__ == \
        'OrderedDict'
    for target in ('optax.adamw', 'fitv2_tpu.parallel.mesh.make_mesh',
                   'fitv2_tpu.ops.flash_attention.nope'):
        with pytest.raises(NotImplementedError, match='no counterpart'):
            resolve_target(target)


def test_config_targets_never_import_jax():
    """A fresh interpreter resolves every target of the YAMLs it can
    without importing jax, flax, optax or the JAX package."""
    code = (
        'import sys, yaml, glob\n'
        'from fitv2_tpu_torch.utils import get_obj_from_str\n'
        'def targets(n):\n'
        '    if isinstance(n, dict):\n'
        '        if "target" in n: yield n["target"]\n'
        '        for v in n.values(): yield from targets(v)\n'
        'n = 0\n'
        'for p in sorted(glob.glob("configs/*.yaml")):\n'
        '    for t in targets(yaml.safe_load(open(p))):\n'
        '        try:\n'
        '            get_obj_from_str(t); n += 1\n'
        '        except NotImplementedError:\n'
        '            assert t.startswith("optax."), t\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in\n'
        '       ("jax", "flax", "optax", "fitv2_tpu")]\n'
        'assert n > 10 and not bad, (n, bad)\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))


# -- training_stats -----------------------------------------------------------

def test_moments_and_collector_match_jax():
    rng = np.random.default_rng(0)
    values = [rng.standard_normal(n).astype(np.float32) * 3 + 1
              for n in (5, 17, 1)]
    for v in values:
        ref = np.asarray(jstats.moments(jnp.asarray(v)))
        out = training_stats.moments(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(out, ref, rtol=TOL)
    np.testing.assert_allclose(
        training_stats.psum_moments(torch.from_numpy(values[0])).numpy(),
        np.asarray(jstats.moments(jnp.asarray(values[0]))), rtol=TOL)
    for v in values:
        jstats.report('loss', jnp.asarray(v))
        training_stats.report('loss', torch.from_numpy(v))
    jstats.report('other', jnp.asarray(2.0))
    training_stats.report0('other', 2.0)
    jc, pc = jstats.Collector(regex='loss'), training_stats.Collector(
        regex='loss')
    assert pc.names() == [] and pc.num('loss') == jc.num('loss') == 23
    np.testing.assert_allclose(pc.mean('loss'), jc.mean('loss'), rtol=TOL)
    np.testing.assert_allclose(pc.std('loss'), jc.std('loss'), rtol=TOL)
    np.testing.assert_allclose(pc.std('loss'), np.concatenate(values).std(),
                               rtol=1e-5)
    assert np.isnan(pc.mean('missing')) and pc.std('missing') == 0.0
    jstats.report('loss', jnp.asarray(1.0))
    training_stats.report('loss', 1.0)
    pc.update()
    jc.update()
    assert pc.as_dict() == jc.as_dict() == {
        'loss': {'num': 1.0, 'mean': 1.0, 'std': 0.0}}
    pc.update()  # nothing new: the snapshot stays
    assert pc.num('loss') == 1.0
    whole = training_stats.Collector()
    assert whole.as_dict()['other']['mean'] == 2.0


# -- misc ---------------------------------------------------------------------

def test_easydict_and_assert_shape():
    d = misc.EasyDict(a=1)
    d.b = 2
    assert d.a == 1 and d['b'] == 2
    with pytest.raises(AttributeError):
        _ = d.missing
    del d.b
    assert 'b' not in d
    x = torch.zeros(2, 3, 4)
    misc.assert_shape(x, (2, None, 4))
    for bad in ((2, 3), (2, 3, 5)):
        with pytest.raises(AssertionError) as got:
            misc.assert_shape(x, bad)
        with pytest.raises(AssertionError) as want:
            jmisc.assert_shape(jnp.zeros((2, 3, 4)), bad)
        assert str(got.value) == str(want.value)


def test_nan_to_num_matches_jax():
    x = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    for kw in ({}, dict(nan=2.0, posinf=9.0, neginf=-9.0)):
        ref = np.asarray(jmisc.nan_to_num(jnp.asarray(x), **kw))
        assert np.array_equal(misc.nan_to_num(torch.from_numpy(x),
                                              **kw).numpy(), ref)


def test_param_summary_and_count_match_jax(capsys):
    tree = {'a': {'w': np.zeros((4, 8), np.float32)},
            'b': np.zeros((3,), np.float32)}
    jtree = {'a': {'w': jnp.zeros((4, 8))}, 'b': jnp.zeros((3,))}
    ttree = {'a': {'w': torch.zeros(4, 8)}, 'b': torch.zeros(3)}
    assert misc.count_params(ttree) == jmisc.count_params(jtree) == 35
    assert misc.print_module_summary(ttree) == \
        jmisc.print_module_summary(jtree)
    assert misc.print_module_summary(tree, max_rows=1) == \
        jmisc.print_module_summary(jtree, max_rows=1)
    capsys.readouterr()
    lin = torch.nn.Linear(4, 8)
    assert misc.count_params(lin) == 40
    assert 'weight' in misc.print_module_summary(lin)


def test_flop_count_matches_jax():
    for kw in (dict(hidden=1152, depth=36, n_tokens=256),
               dict(hidden=384, depth=12, n_tokens=256, mlp_hidden=1024)):
        assert misc.flop_count_forward(**kw) == jmisc.flop_count_forward(
            **kw)
    flops = misc.flop_count_forward(hidden=1152, depth=36, n_tokens=256)
    assert abs(flops / 2 - 147e9) / 147e9 < 0.1


def test_profiling_hooks_and_consistency(tmp_path):
    @misc.profiled_function
    def double(x):
        return x * 2

    with misc.trace_to(str(tmp_path)) as prof:
        assert torch.equal(double(torch.ones(3)), torch.full((3,), 2.0))
    assert double.__name__ == 'double'
    assert any(e.key == 'double' for e in prof.key_averages())
    assert os.path.getsize(tmp_path / 'trace.json') > 0
    assert misc.check_cross_process_consistency(torch.ones(2))


# -- eval_args and measure ----------------------------------------------------

def test_eval_args_match_jax():
    argvs = ([], ['--sde-sampling-method', 'Heun', '--last-step', 'None',
                  '--diffusion-form', 'SBDM', '--ode-sampling-method',
                  'heun', '--atol', '1e-5', '--reverse'])
    for argv in argvs:
        parsed = []
        for mod in (jeval_args, eval_args):
            p = argparse.ArgumentParser()
            mod.parse_sde_args(p)
            mod.parse_ode_args(p)
            a = p.parse_args(argv)
            parsed.append((vars(a), mod.sde_kwargs_from_args(a),
                           mod.ode_kwargs_from_args(a)))
        assert parsed[0] == parsed[1]
    assert eval_args.none_or_str('None') is None


def test_measure_stats_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
    other = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
    out = measure.measure_all(img, other)
    assert out == jmeasure.measure_all(img, other)
    assert 0 <= out['hf_ratio'] <= 1 and out['spectral_entropy'] > 0
    np.testing.assert_allclose(measure.measure_all(img, img)['ssim'], 1.0,
                               rtol=1e-6)
    smooth = np.tile(np.linspace(0, 255, 32)[:, None, None],
                     (1, 32, 3)).astype(np.uint8)
    assert measure.measure_all(smooth)['hf_ratio'] < out['hf_ratio']
