"""PyTorch port, FID evaluation (fitv2_tpu_torch.eval, ckpt's Inception
carrier, cli.evaluate) against the JAX package on the CPU.

The same seeded pytorch-fid-layout state dict goes through both packages'
converters; the JAX parameters also cross over with
``inception_state_from_jax``. Tolerances:
  - the resize: 2e-5 abs against ``jax.image.resize`` at its own [0, 1]
    scale (JAX's CPU resize is itself ~1.3e-5 off the exact product of its
    weights at 320 -> 299); 1e-6 against that exact product (measured
    <= 3e-7);
  - InceptionV3: rtol 2e-4 / atol 2e-3, the JAX golden test's own bound
    (tests/test_inception_golden.py);
  - statistics: 1e-10 (the same float64 numpy arithmetic);
  - the CLI's JSON: 1e-4 relative (activations differ by float32 summation
    order).
"""

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import jax
import jax.numpy as jnp

from fitv2_tpu.cli import evaluate as j_cli
from fitv2_tpu.eval import evaluator as j_evaluator
from fitv2_tpu.eval import inception as j_inception
from fitv2_tpu.eval import statistics as j_stats

from fitv2_tpu_torch.ckpt import inception_state_from_jax
from fitv2_tpu_torch.cli import evaluate as cli
from fitv2_tpu_torch.eval import evaluator, inception, statistics

TOL_RESIZE = 2e-5
TOL_STATS = 1e-10
TOL_JSON = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope='module')
def weights():
    """A seeded pytorch-fid-layout state dict, the JAX params converted
    from it, and the port's InceptionV3 holding them."""
    sd = inception.random_fid_state_dict(seed=3)
    params = j_inception.convert_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    model = inception.InceptionV3()
    model.load_state_dict(inception_state_from_jax(params))
    return sd, params, model.eval()


@pytest.fixture(scope='module')
def j_apply():
    """JAX's InceptionV3 on a (2, 299, 299, 3) batch, the params an
    argument: the module's one compile of the network, shared by the
    network comparison and the CLI comparison."""
    jm = j_inception.InceptionV3()
    return jax.jit(lambda p, x: jm.apply({'params': p}, x))


@pytest.fixture(scope='module')
def outputs(weights, j_apply):
    """Both networks on the same two 299 x 299 inputs."""
    _, params, model = weights
    x = np.random.default_rng(0).uniform(-1, 1, (2, 299, 299, 3)
                                         ).astype(np.float32)
    want = j_apply(params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return got, {k: np.asarray(v) for k, v in want.items()}


def images(seed, n, h=64, w=64):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


# -- preprocessing ---------------------------------------------------------------

SIZES = [(64, 64), (256, 256), (512, 512), (160, 320), (320, 640),
         (299, 299)]


@pytest.mark.parametrize('hw', SIZES)
def test_preprocess_matches_jax_resize(hw):
    im = images(1, 2, *hw)
    got = inception.preprocess_uint8(torch.from_numpy(im)).numpy()
    assert got.shape == (2, 299, 299, 3)
    want = np.asarray(jax.image.resize(
        jnp.asarray(im, jnp.float32) / 255.0, (2, 299, 299, 3), 'bilinear'))
    np.testing.assert_allclose((got + 1.0) / 2.0, want, rtol=0,
                               atol=TOL_RESIZE)


@pytest.mark.parametrize('hw', SIZES)
def test_preprocess_is_the_product_of_jax_resize_weights(hw):
    """Against the exact (float64) product of the per-axis weight matrices
    ``jax.image.resize`` builds: antialiased where an axis shrinks."""
    from jax._src.image import scale as j_scale
    im = images(2, 2, *hw)
    got = inception.preprocess_uint8(torch.from_numpy(im)).numpy()
    wh, ww = (np.asarray(j_scale.compute_weight_mat(
        n, 299, 299 / n, 0.0, j_scale._fill_triangle_kernel, True),
        np.float64) if n != 299 else np.eye(299) for n in hw)
    exact = np.einsum('nkwc,wl->nklc', np.einsum(
        'nhwc,hk->nkwc', im / 255.0, wh, optimize=True), ww, optimize=True)
    np.testing.assert_allclose(got, exact * 2 - 1, rtol=0, atol=1e-6)


# -- the network -----------------------------------------------------------------

@pytest.mark.parametrize('key', ['pool3', 'spatial', 'logits'])
def test_inception_matches_jax(outputs, key):
    got, want = outputs
    assert got[key].shape == want[key].shape
    assert want[key].shape[1] == {'pool3': 2048, 'spatial': 2023,
                                  'logits': 1008}[key]
    np.testing.assert_allclose(got[key].numpy(), want[key], rtol=2e-4,
                               atol=2e-3)


def test_spatial_is_mixed_6e_flattened_nhwc(weights, outputs):
    _, _, model = weights
    seen = {}
    handle = model.Mixed_6e.register_forward_hook(
        lambda m, i, o: seen.setdefault('x', o))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 299, 299, 3)
                                         ).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    handle.remove()
    m6e = seen['x']
    assert m6e.shape == (2, 768, 17, 17)
    nhwc = m6e[:, :7].permute(0, 2, 3, 1).reshape(2, -1)
    assert torch.equal(out['spatial'], nhwc)
    assert not torch.equal(nhwc, m6e[:, :7].reshape(2, -1))


def test_pools_match_flax():
    from flax import linen as nn
    x = np.random.default_rng(2).standard_normal((2, 9, 11, 5)
                                                 ).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(
        nhwc(inception._avg_pool(xt)),
        np.asarray(j_inception._avg_pool_cip_false(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        nhwc(inception._max_pool(xt)),
        np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), (2, 2))))
    np.testing.assert_array_equal(
        nhwc(torch.nn.functional.max_pool2d(xt, 3, stride=1, padding=1)),
        np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), (1, 1), 'SAME')))


def test_convert_state_dict_matches_jax(weights):
    sd, params, _ = weights
    ours = inception.convert_inception_state_dict(sd)
    theirs = inception_state_from_jax(params)
    assert set(ours) == set(theirs) == set(inception.InceptionV3()
                                           .state_dict())
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    # numpy arrays in give the same tensors
    ours_np = inception.convert_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert all(torch.equal(ours[k], ours_np[k]) for k in ours)


def test_compute_activations_matches_jax_with_a_ragged_batch(weights):
    """5 images at batch 2: JAX pads its last batch, the port does not; the
    rows are the same."""
    sd, params, model = weights
    im = images(4, 5, 48, 80)
    got = inception.compute_activations(model, im, batch_size=2)
    want = j_inception.compute_activations(j_inception.InceptionV3(), params,
                                           im, batch_size=2)
    whole = inception.compute_activations(model, im, batch_size=8)
    for k in ('pool3', 'spatial', 'softmax'):
        assert got[k].shape == want[k].shape and got[k].shape[0] == 5
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(got[k], whole[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got['softmax'].sum(-1), 1.0, rtol=1e-5)


def test_random_weights_are_seeded():
    a = inception.load_inception(None, 'cpu').state_dict()
    b = inception.load_inception(None, 'cpu').state_dict()
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a['fc.weight'].std() > 0


# -- statistics ------------------------------------------------------------------

@pytest.fixture(scope='module')
def feats():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((60, 12)).astype(np.float32)
    b = (rng.standard_normal((50, 12)) * 1.2 + 0.3).astype(np.float32)
    p = rng.dirichlet(np.ones(10), size=40).astype(np.float32)
    return a, b, p


def _equal(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_STATS,
                                   atol=TOL_STATS)


STAT_CASES = {
    'activation_statistics': lambda m, a, b, p: m.activation_statistics(a),
    'frechet_distance': lambda m, a, b, p: m.frechet_distance(
        *m.activation_statistics(a), *m.activation_statistics(b)),
    'fid_from_activations': lambda m, a, b, p: m.fid_from_activations(a, b),
    'inception_score': lambda m, a, b, p: m.inception_score(p, 15),
    'knn_radii': lambda m, a, b, p: m.knn_radii(a, 3),
    'manifold_membership': lambda m, a, b, p: m.manifold_membership(
        b, a, m.knn_radii(a, 3)),
    'precision_recall': lambda m, a, b, p: m.precision_recall(a, b),
    'compute_all_metrics': lambda m, a, b, p: m.compute_all_metrics(
        a, a[:, :6], b, b[:, :6], p),
}


@pytest.mark.parametrize('name', list(STAT_CASES))
def test_statistics_match_jax(feats, name):
    got = STAT_CASES[name](statistics, *feats)
    want = STAT_CASES[name](j_stats, *feats)
    _equal(got, want)


def test_blocked_neighbours_equal_the_whole_matrix(feats):
    """Rows in blocks of 7 (N 60 and 50): the radii and the memberships of
    JAX's one N x N matrix."""
    a, b, _ = feats
    radii = statistics.knn_radii(a, 3, block=7)
    _equal(radii, j_stats.knn_radii(a, 3))
    inside = statistics.manifold_membership(b, a, radii, block=7)
    assert np.array_equal(inside, j_stats.manifold_membership(b, a, radii))
    assert 0 < inside.mean() < 1


def test_load_reference_statistics(tmp_path):
    path = str(tmp_path / 'ref.npz')
    np.savez(path, mu=np.arange(3.0), sigma=np.eye(3))
    got = statistics.load_reference_statistics(path)
    want = j_stats.load_reference_statistics(path)
    assert set(got) == set(want) == {'mu', 'sigma'}
    _equal(got, want)


# -- the evaluator and the CLI ---------------------------------------------------

def test_evaluator_on_identical_batches(tmp_path):
    ev = evaluator.Evaluator(batch_size=4, device='cpu')
    assert not ev.comparable_to_published
    imgs = images(6, 6, 32, 32)
    path = str(tmp_path / 'batch.npz')
    np.savez(path, arr_0=imgs)
    m = ev.compute_all(imgs, path)
    assert set(m) == {'fid', 'sfid', 'inception_score', 'precision',
                      'recall'}
    assert abs(m['fid']) < 1e-3 and abs(m['sfid']) < 1e-3
    assert m['precision'] == m['recall'] == 1.0
    st = ev.compute_statistics(ev.read_activations(imgs[:3]))
    assert st['mu'].shape == (2048,) and st['sigma'].shape == (2048, 2048)
    assert st['mu_s'].shape == (2023,)


def test_create_npz_from_sample_folder(tmp_path):
    from PIL import Image
    folder = tmp_path / 'samples'
    folder.mkdir()
    imgs = images(7, 3, 16, 24)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(folder / f'{i:06d}.png')
    path = evaluator.create_npz_from_sample_folder(str(folder), 3)
    assert np.array_equal(np.load(path)['arr_0'], imgs)
    assert path == j_evaluator.create_npz_from_sample_folder(str(folder), 3)


def _run_cli(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope='module')
def j_activations(j_apply):
    """JAX's activations for its CLI: ``j_apply`` on JAX's preprocessing,
    two images at a time, each npz's computed once in this module. JAX's
    own ``compute_activations`` closes over the params and so compiles the
    network anew at every call (the ragged-batch test above runs it as it
    is)."""
    memo = {}

    def compute(model, params, images_uint8, batch_size=64):
        key = (images_uint8.shape, images_uint8.tobytes())
        if key not in memo:
            outs = {'pool3': [], 'spatial': [], 'softmax': []}
            for i in range(0, images_uint8.shape[0], 2):
                res = j_apply(params, j_inception.preprocess_uint8(
                    jnp.asarray(images_uint8[i:i + 2])))
                outs['pool3'].append(np.asarray(res['pool3']))
                outs['spatial'].append(np.asarray(res['spatial']))
                outs['softmax'].append(np.asarray(
                    jax.nn.softmax(res['logits'], axis=-1)))
            memo[key] = {k: np.concatenate(v) for k, v in outs.items()}
        return memo[key]
    return compute


@pytest.mark.parametrize('ref_form', ['images', 'statistics'])
def test_cli_matches_jax(weights, j_activations, tmp_path, capsys,
                         monkeypatch, ref_form):
    """Both CLIs on the same two npz files and the same weights file."""
    monkeypatch.setattr(j_evaluator, 'compute_activations', j_activations)
    sd = weights[0]
    wpath = str(tmp_path / 'pt_inception.safetensors')
    save_file({k: v.numpy() for k, v in sd.items()}, wpath)
    ref, samp = str(tmp_path / 'ref.npz'), str(tmp_path / 'samp.npz')
    ref_imgs = images(8, 8, 64, 64)
    samp_imgs = images(9, 8, 96, 64)
    np.savez(samp, arr_0=samp_imgs)
    if ref_form == 'images':
        np.savez(ref, arr_0=ref_imgs)
    else:
        ev = evaluator.Evaluator(wpath, device='cpu')
        np.savez(ref, **ev.compute_statistics(ev.read_activations(ref_imgs)))
    flags = [ref, samp, '--inception-weights', wpath, '--batch-size', '4']
    got = _run_cli(cli.main, flags + ['--device', 'cpu'], capsys)
    want = _run_cli(j_cli.main, flags, capsys)
    keys = {'fid', 'sfid', 'inception_score', 'comparable_to_published'}
    if ref_form == 'images':
        keys |= {'precision', 'recall'}
    assert set(got) == set(want) == keys
    assert got['comparable_to_published'] is False
    for k in keys - {'comparable_to_published'}:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_JSON, atol=0)


def test_cli_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main([str(tmp_path / 'a.npz'), str(tmp_path / 'b.npz')])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        evaluator.Evaluator()
