"""PyTorch port (fitv2_tpu_torch.data): the resumable sampler, the latent
shard loader and its two backends, and the port's safetensors reader and
writer, against the JAX package and the ``safetensors`` package on the same
shards and seeds.

Everything here is exact: index streams, the per-sample draws (source and
flip, keyed by (seed, global batch index, j)) and the padded batches must
be equal, element for element.
"""

import os

import numpy as np
import pytest

from fitv2_tpu.data import latent_dataset as jld
from fitv2_tpu.data import sampler as jsampler

from fitv2_tpu_torch.data import latent_dataset as tld
from fitv2_tpu_torch.data import native_loader, safetensors_np
from fitv2_tpu_torch.data import sampler as tsampler


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    """Non-square synthetic shards padded to 64 tokens, plus a second
    bucket so that the resize-or-crop draw has two choices for some
    files."""
    root = str(tmp_path_factory.mktemp('latents'))
    jld.make_synthetic_latent_shards(root, n=12, target_len=64,
                                     n_classes=10, seed=3)
    src = os.path.join(root, 'from_16_to_64')
    for sub, seed in (('greater_than_64_resize', 4),
                      ('greater_than_64_crop', 5)):
        tmp = os.path.join(root, f'tmp_{sub}')
        jld.make_synthetic_latent_shards(tmp, n=6, target_len=64,
                                         n_classes=10, seed=seed)
        os.rename(os.path.join(tmp, 'from_16_to_64'),
                  os.path.join(root, sub))
    assert os.listdir(src)
    return root


def _assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('dataset_len,batch,max_steps,resume', [
    (10, 4, 7, 0), (10, 4, 7, 3), (3, 8, 5, 2), (37, 6, 11, 10)])
def test_sampler_matches_jax(dataset_len, batch, max_steps, resume):
    ours = tsampler.get_train_sampler(dataset_len, batch, max_steps, resume,
                                      seed=7)
    ref = jsampler.get_train_sampler(dataset_len, batch, max_steps, resume,
                                     seed=7)
    np.testing.assert_array_equal(ours, ref)
    for p in range(2):
        np.testing.assert_array_equal(
            tsampler.shard_indices(ours, batch, p, 2),
            jsampler.shard_indices(ref, batch, p, 2))
    assert (list(tsampler.batched(ours, batch))
            == list(jsampler.batched(ref, batch)))


def test_infinite_sampler_matches_jax():
    import itertools
    for proc in range(2):
        ours = tsampler.infinite_sampler(13, proc, 2, seed=5)
        ref = jsampler.infinite_sampler(13, proc, 2, seed=5)
        assert (list(itertools.islice(ours, 60))
                == list(itertools.islice(ref, 60)))


def test_dataset_sample_matches_jax(shards):
    ours = tld.IN1kLatentDataset(shards, target_len=64)
    ref = jld.IN1kLatentDataset(shards, target_len=64)
    assert ours.files == ref.files
    assert any(len(c) == 2 for c in ours.files)
    for idx in range(len(ours)):
        a = ours.get(idx, np.random.Generator(np.random.PCG64(idx)))
        b = ref.get(idx, np.random.Generator(np.random.PCG64(idx)))
        _assert_batches_equal([a], [b])


@pytest.mark.parametrize('backend', ['python', 'native'])
@pytest.mark.parametrize('resume', [0, 2])
def test_loader_batches_match_jax(shards, backend, resume):
    """The port's loader, either backend, yields the JAX package's Python
    path's batches for the same shards, seed and resume step."""
    ours = tld.INLatentLoader(shards, target_len=64, batch_size=4,
                              num_workers=2, backend=backend)
    ref = jld.INLatentLoader(shards, target_len=64, batch_size=4,
                             num_workers=2)
    kw = dict(global_batch_size=4, max_steps=6, resume_step=resume, seed=11)
    port_batches = list(ours.train_dataloader(**kw))
    it = ref.train_dataloader(**kw, process_index=0, process_count=1)
    it.use_native = False
    _assert_batches_equal(port_batches, list(it))
    assert len(port_batches) == 6 - resume


def test_native_and_python_backends_agree(shards):
    ds = tld.IN1kLatentDataset(shards, target_len=64)
    stream = tsampler.get_train_sampler(len(ds), 3, 5, 0, seed=9)
    batches = {b: list(tld.PrefetchLoader(ds, stream, 3, num_workers=2,
                                          seed=9, backend=b, batch_offset=4))
               for b in tld.BACKENDS}
    _assert_batches_equal(batches['native'], batches['python'])


def test_native_library_builds_in_the_port():
    path = native_loader.library_path()
    native_loader.load_library()
    assert os.path.isfile(path)
    assert path.startswith(native_loader.BUILD_DIR)


def test_native_failure_raises(tmp_path):
    with pytest.raises(RuntimeError):
        native_loader.load_batch([str(tmp_path / 'missing.safetensors')],
                                 [0], target_len=64)
    with pytest.raises(ValueError):
        tld.PrefetchLoader(None, np.arange(4), 2, backend='auto')


def test_loader_error_reaches_the_consumer(shards, tmp_path):
    """A shard that cannot be read raises in the training loop's thread,
    from either backend."""
    ds = tld.IN1kLatentDataset(shards, target_len=64)
    ds.files = [[str(tmp_path / 'missing.safetensors')]] * len(ds.files)
    for backend in tld.BACKENDS:
        with pytest.raises((RuntimeError, FileNotFoundError)):
            list(tld.PrefetchLoader(ds, np.arange(4), 2, num_workers=1,
                                    backend=backend))


def test_safetensors_reader_and_writer_against_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    rng = np.random.default_rng(0)
    tensors = {
        'feature': rng.standard_normal((2, 3, 5, 16)).astype(np.float32),
        'grid': rng.integers(0, 9, (2, 15)).astype(np.int32),
        'size': np.array([3, 5], np.int32),
        'label': np.array(7, np.int32),
        'f16': rng.standard_normal(4).astype(np.float16),
        'i64': rng.integers(-5, 5, (2, 2)),
    }
    theirs = str(tmp_path / 'theirs.safetensors')
    ours = str(tmp_path / 'ours.safetensors')
    save_file(tensors, theirs, metadata={'format': 'np'})
    safetensors_np.save_file(tensors, ours)
    for read in (safetensors_np.load_file(theirs), load_file(ours)):
        assert set(read) == set(tensors)
        for k, v in tensors.items():
            assert read[k].dtype == v.dtype and read[k].shape == v.shape, k
            np.testing.assert_array_equal(read[k], v, err_msg=k)


def test_safetensors_reader_refuses_a_bad_file(tmp_path):
    path = str(tmp_path / 'bad.safetensors')
    safetensors_np.save_file({'x': np.zeros(4, np.float32)}, path)
    with open(path, 'rb') as f:
        data = f.read()
    with open(path, 'wb') as f:
        f.write(data[:-4])  # cut the payload short
    with pytest.raises(ValueError):
        safetensors_np.load_file(path)


def test_synthetic_shards_match_jax(tmp_path):
    """The port writes the JAX package's synthetic shards: the same tensors
    under the same names."""
    for pkg, name in ((tld, 'ours'), (jld, 'ref')):
        pkg.make_synthetic_latent_shards(str(tmp_path / name), n=5,
                                         target_len=16, n_classes=10, seed=2)
    sub = 'from_16_to_16'
    files = sorted(os.listdir(tmp_path / 'ref' / sub))
    assert sorted(os.listdir(tmp_path / 'ours' / sub)) == files
    for f in files:
        a = safetensors_np.load_file(str(tmp_path / 'ours' / sub / f))
        b = safetensors_np.load_file(str(tmp_path / 'ref' / sub / f))
        _assert_batches_equal([a], [b])
