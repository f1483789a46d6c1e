"""PyTorch port, slice 5c: from raw images to training. The 'dots' and
'dots_all' remat policies (selective activation checkpointing) and
'dots_offload' (slice 10: dots' saved products kept in host memory), the
SD-VAE encoder, data/imagenet.py and cli/prepare_latents, against the JAX
package on the same numpy inputs.

Sizes: a FiTv2 of depth 2, hidden 64, 4 heads of Dh 16, context 16; VAE
encoders of widths (8, 16) (the golden's) and (8, 16, 16, 16) (factor 8,
the prep tool's geometry); images up to 200 x 180 px.

Tolerances:
- remat: the gradients under 'dots' / 'dots_all' / 'dots_offload' equal
  'full' and no remat bit for bit (the same CPU ops on the same inputs,
  the saved products being the forward's own, or copies of them); against
  JAX's FiT under the same policy, 1e-5 of each gradient's largest
  magnitude (fp32 summed in other orders);
- the encoder's moments: 1e-5 of their largest magnitude against the
  golden's torch twin and against JAX's ``encode`` (fp32 convolutions);
- imagenet.py: equal (the same PIL calls and the same PCG64 stream);
- prepare_latents: the same files and keys, grid, size and label equal,
  features within 1e-5 of their largest magnitude.
"""

import os
import os.path as osp
import pickle
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from fitv2_tpu.data import imagenet as jimagenet
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.vae import AutoencoderKL as JAutoencoderKL
from fitv2_tpu.vae.autoencoder_kl import sample_latent as j_sample_latent

from fitv2_tpu_torch.ckpt import state_dict_from_jax
from fitv2_tpu_torch.cli import prepare_latents as tprep
from fitv2_tpu_torch.data import imagenet as timagenet
from fitv2_tpu_torch.data import safetensors_np
from fitv2_tpu_torch.models import FiT, remat
from fitv2_tpu_torch.vae import (
    AutoencoderKL, convert_diffusers_state_dict, sample_latent,
    state_dict_from_flax)

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            'tools'))
import prepare_latents as jprep  # noqa: E402

TINY = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
            depth=2, num_heads=4, learn_sigma=False, use_sit=True,
            use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
            adaln_type='lora', adaln_lora_dim=16, num_classes=10,
            max_cached_len=16)
TOL = 1e-5
GOLDENS = osp.join(osp.dirname(__file__), 'goldens')
_aten = torch.ops.aten
MATMULS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
           _aten.baddbmm.default)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(4)
    grid = np.stack([np.indices((4, 4)).reshape(2, 16)] * 2).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 12:] = 0
    return dict(x=rng.standard_normal((2, 16, 16)).astype(np.float32),
                t=np.array([0.3, 0.7], np.float32),
                y=np.array([1, 2], np.int32), grid=grid, mask=mask,
                size=np.array([[[4, 4]], [[3, 4]]], np.int32),
                w=rng.standard_normal((2, 16, 16)).astype(np.float32))


@pytest.fixture(scope='module')
def jax_params():
    """Randomised JAX FiT params (every leaf, so no output is the
    adaLN-zero 0) and the inputs."""
    a = _inputs()
    shapes = jax.eval_shape(
        JFiT(**TINY).init, jax.random.PRNGKey(0), jnp.asarray(a['x']),
        jnp.asarray(a['t']), jnp.asarray(a['y']), jnp.asarray(a['grid']),
        jnp.asarray(a['mask']), jnp.asarray(a['size']))['params']
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    return params, a


def _port(params, policy):
    kw = dict(TINY) if policy == 'none' else dict(
        TINY, use_checkpoint=True, remat_policy=policy)
    model = FiT(**kw)
    model.load_state_dict(state_dict_from_jax(
        params, depth=2, num_heads=4, adaln_type='lora'))
    return model


def _port_grads(model, a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = model(t['x'], t['t'], t['y'], t['grid'].long(), t['mask'],
                t['size'].long())
    (out * t['w']).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}


class _Matmuls(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in MATMULS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('policy', ['dots', 'dots_all', 'dots_offload'])
def test_selective_remat_gradients_equal_full_and_none(jax_params, policy):
    params, a = jax_params
    grads = {p: _port_grads(_port(params, p), a)
             for p in ('none', 'full', policy)}
    for name, g in grads['none'].items():
        assert torch.equal(grads[policy][name], g), name
        assert torch.equal(grads['full'][name], g), name


@pytest.mark.parametrize('policy', ['dots', 'dots_all', 'dots_offload'])
def test_selective_remat_matches_jax(jax_params, policy):
    params, a = jax_params
    jm = JFiT(**TINY, use_checkpoint=True, remat_policy=policy)

    def loss(p):
        out = jm.apply({'params': p}, jnp.asarray(a['x']),
                       jnp.asarray(a['t']), jnp.asarray(a['y']),
                       jnp.asarray(a['grid']), jnp.asarray(a['mask']),
                       jnp.asarray(a['size']))
        return jnp.sum(out * jnp.asarray(a['w']))

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, params)))
    want = state_dict_from_jax(jgrads, depth=2, num_heads=4,
                               adaln_type='lora')
    got = _port_grads(_port(params, policy), a)
    assert set(got) == set(want)
    for name, g in got.items():
        assert _rel(g, want[name]) <= TOL, name


def test_dots_recomputes_no_matrix_product(jax_params):
    """The backward's matrix products: 'dots' reruns none of the blocks'
    forward mm/addmm (the CPU attention's bmm it does, as JAX's
    batch-dimension dots are recomputed too), 'dots_offload' as many as
    'dots', 'dots_all' none at all, 'full' every one of the blocks' forward
    products."""
    params, a = jax_params
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    counts = {}
    for policy in ('none', 'full', 'dots', 'dots_all', 'dots_offload'):
        model = _port(params, policy)
        with _Matmuls() as fwd_blocks:
            # the blocks' forward products, as the recompute runs them
            with torch.no_grad():
                model.blocks[0](torch.zeros(2, 16, 64), torch.zeros(2, 64),
                                t['mask'], torch.zeros(2, 16, 16),
                                torch.zeros(2, 16, 16),
                                torch.zeros(2, 6 * 64))
        out = model(t['x'], t['t'], t['y'], t['grid'].long(), t['mask'],
                    t['size'].long())
        with _Matmuls() as bwd:
            (out * t['w']).sum().backward()
        counts[policy] = bwd.count
    per_block = fwd_blocks.count
    mm_per_block = 2 + 2 + 2  # adaLN fc1, fc_out; qkv, proj; fc1, fc2
    bmm_per_block = per_block - mm_per_block
    assert bmm_per_block == 2  # q k^T and p v, the plain CPU attention
    assert counts['full'] == counts['none'] + 2 * per_block
    assert counts['dots'] == counts['none'] + 2 * bmm_per_block
    assert counts['dots_offload'] == counts['dots']
    assert counts['dots_all'] == counts['none']


class _BlockProducts(TorchDispatchMode):
    """The mm/addmm outputs dispatched while it is active, each with the
    index of the block that made it (None outside the blocks)."""

    def __init__(self, blocks):
        super().__init__()
        self.outs, self._inside = [], []
        for i, block in enumerate(blocks):
            block.register_forward_pre_hook(self._enter(i))
            block.register_forward_hook(self._exit)

    def _enter(self, i):
        def hook(module, args):
            self._inside.append(i)
        return hook

    def _exit(self, module, args, out):
        self._inside.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in remat.REMAT_SAVED_OPS['dots']:
            self.outs.append((self._inside[-1] if self._inside else None,
                              out))
        return out


def test_dots_offload_store_holds_copies_of_the_products(jax_params):
    """'dots_offload' on the CPU: after the forward each block's store
    holds a copy (another storage, equal values) of each of the block's
    mm/addmm outputs, 6 a block at TINY, in the forward's order; the
    backward empties every store (nothing carries into the next step) and
    moves each byte back once; a second backward raises, as torch's
    selective checkpointing does."""
    params, a = jax_params
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    model = _port(params, 'dots_offload')
    sessions = []
    new_session = model._remat

    def remat_fn():
        sessions.append(new_session())
        return sessions[-1]

    model._remat = remat_fn
    remat.reset_counts()
    with _BlockProducts(model.blocks) as seen:
        out = model(t['x'], t['t'], t['y'], t['grid'].long(), t['mask'],
                    t['size'].long())
    (session,) = sessions
    assert len(session.stores) == TINY['depth']
    nbytes = 0
    for i, store in enumerate(session.stores):
        made = [o for block, o in seen.outs if block == i]
        assert len(store) == len(made) == 6
        for entry, product in zip(store.entries.values(), made):
            assert torch.equal(entry.host, product)
            assert entry.host.untyped_storage().data_ptr() != \
                product.untyped_storage().data_ptr()
            nbytes += product.numel() * product.element_size()
    assert remat.counts == dict(d2h_bytes=nbytes, h2d_bytes=0,
                                d2h_copies=12, h2d_copies=0)
    loss = (out * t['w']).sum()
    loss.backward(retain_graph=True)
    assert [len(store) for store in session.stores] == [0, 0]
    assert remat.counts == dict(d2h_bytes=nbytes, h2d_bytes=nbytes,
                                d2h_copies=12, h2d_copies=12)
    with pytest.raises(RuntimeError, match='backward an extra time'):
        loss.backward()


def test_dots_offload_keeps_nothing_where_it_was_made():
    """No fallback: an output of another device than the CPU or a card
    raises, and a pinned allocation that fails names its bytes."""
    save, _ = remat.OffloadSession()()
    with pytest.raises(NotImplementedError, match='keeps no outputs of meta'):
        save.store.save((_aten.mm.default, 0), torch.empty(4, device='meta'))
    if not torch.cuda.is_available():  # no pinned allocator on this host
        with pytest.raises(MemoryError, match=f'pinning {1 << 30} bytes'):
            remat.PinnedPool().take(100, None)


# ---------------------------------------------------------------------------
# the VAE encoder
# ---------------------------------------------------------------------------

def test_encoder_matches_golden():
    """The golden's diffusers-layout twin: moments (mean | logvar)."""
    g = np.load(osp.join(GOLDENS, 'vae.npz'))
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files
          if k.startswith('sd:')}
    vae = AutoencoderKL((8, 16))
    vae.load_state_dict(convert_diffusers_state_dict(sd), strict=True)
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(
            g['x'].transpose(0, 2, 3, 1)))
    want = g['moments'].transpose(0, 2, 3, 1)
    assert mean.shape == (2, 16, 16, 4)
    assert _rel(mean, want[..., :4]) <= TOL
    assert _rel(logvar, np.clip(want[..., 4:], -30, 20)) <= TOL


def _jax_vae(channels, seed=0):
    """JAX's AutoencoderKL and seeded random params of its tree (kernels
    of variance 1 / fan-in, so the moments are O(1) and not the residue of
    a cancellation; norm scales near 1), and the port's VAE on them."""
    model = JAutoencoderKL(block_out_channels=channels)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 16, 16, 3)))['params']
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        std = (np.prod(s.shape[:-1]) ** -0.5 if name == 'kernel' else 0.05)
        return (float(name == 'scale') + std * rng.standard_normal(
            s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    vae = AutoencoderKL(channels)
    vae.load_state_dict(state_dict_from_flax(params), strict=True)
    return model, params, vae.eval()


def test_encoder_matches_jax_encode():
    """Downsample's asymmetric pad (a symmetric padding=1 moves every
    output), the encoder, quant_conv, the logvar clip, sample_latent."""
    model, params, vae = _jax_vae((8, 16, 16, 16))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 40, 24, 3)).astype(
        np.float32)
    jmean, jlogvar = jax.jit(lambda p, v: model.apply(
        {'params': p}, v, method=model.encode))(params, jnp.asarray(x))
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(x))
    assert mean.shape == (2, 5, 3, 4)
    assert _rel(mean, jmean) <= TOL
    assert _rel(logvar, jlogvar) <= TOL
    key = jax.random.PRNGKey(5)
    want = j_sample_latent(key, jmean, jlogvar)
    noise = np.array(jax.random.normal(key, jmean.shape, jmean.dtype))
    got = sample_latent(mean, logvar, torch.from_numpy(noise))
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# data/imagenet.py
# ---------------------------------------------------------------------------

def _png_tree(root, sizes):
    """A class-per-folder tree of random PNGs of (w, h) ``sizes``."""
    from PIL import Image
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(sizes):
        d = osp.join(root, f'class_{i % 2}')
        os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            osp.join(d, f'img_{i}.png'))


@pytest.mark.parametrize('size', [(48, 32), (200, 180), (640, 130)])
def test_crop_and_resize_equal_jax(size):
    from PIL import Image
    img = Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (size[1], size[0], 3), np.uint8))
    for n in (32, 64):
        assert np.array_equal(timagenet.center_crop_arr(img, n),
                              jimagenet.center_crop_arr(img, n))
        assert np.array_equal(timagenet.resize_arr(img, n),
                              jimagenet.resize_arr(img, n))


def test_datasets_equal_jax(tmp_path):
    root = str(tmp_path / 'imgs')
    _png_tree(root, [(48, 32), (200, 180), (64, 64)])
    for mode in ('center_crop', 'resize'):
        got = timagenet.ImagenetDataset(root, 64, mode)
        want = jimagenet.ImagenetDataset(root, 64, mode)
        assert got.samples == want.samples and len(got) == 3
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert np.array_equal(a['jpg'], b['jpg']) and a['cls'] == b['cls']
    data = tmp_path / 'custom'
    os.makedirs(data / 'images')
    os.makedirs(data / 'vae-sd')
    rng = np.random.default_rng(3)
    for i in range(3):
        np.save(data / 'images' / f'{i}.npy', rng.integers(0, 255, (8, 8, 3)))
        np.save(data / 'vae-sd' / f'{i}.npy', rng.standard_normal((4, 1, 1)))
    (data / 'images' / 'dataset.json').write_text(
        '{"labels": [["0.npy", 3], ["2.npy", 7]]}')
    got = timagenet.CustomDataset(str(data))
    want = jimagenet.CustomDataset(str(data))
    assert got.labels == want.labels == [3, 0, 7]
    for i in range(3):
        for a, b in zip(got[i], want[i]):
            assert np.array_equal(a, b)


def test_cifar10_stream_equals_jax(tmp_path):
    base = tmp_path / 'cifar-10-batches-py'
    os.makedirs(base)
    rng = np.random.default_rng(0)
    for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
        with open(base / name, 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 255, (6, 3072), np.uint8),
                         b'labels': list(rng.integers(0, 10, 6))}, f)
    for train in (True, False):
        xs, ys = timagenet.create_cifar10_arrays(str(tmp_path), train)
        jx, jy = jimagenet.create_cifar10_arrays(str(tmp_path), train)
        assert np.array_equal(xs, jx) and np.array_equal(ys, jy)
    got = timagenet.cifar10_loader(str(tmp_path), 4, seed=5)
    want = jimagenet.cifar10_loader(str(tmp_path), 4, seed=5)
    for _ in range(10):  # two epochs of 7 batches: permutations and flips
        a, b = next(got), next(want)
        assert np.array_equal(a['image'], b['image'])
        assert np.array_equal(a['label'], b['label'])


# ---------------------------------------------------------------------------
# cli/prepare_latents
# ---------------------------------------------------------------------------

TARGET_LEN = 16  # the max side: 4 tokens * 16 px = 64 px


@pytest.fixture(scope='module')
def prepared(tmp_path_factory):
    """One PNG folder through JAX's tool and the port's, on one VAE."""
    model, params, vae = _jax_vae((8, 16, 16, 16))

    @jax.jit
    def jencode_jit(x):
        mean, _ = model.apply({'params': params}, x, method=model.encode)
        return mean * 0.18215

    def jencode(x):
        return np.asarray(jencode_jit(jnp.asarray(x)))

    root = str(tmp_path_factory.mktemp('imgs'))
    # 48x32 (3 x 2 native tokens) and 70x70 (4 x 4: the edge) fit 16
    # tokens; 200x180 and 100x60 (6 x 3) do not
    _png_tree(root, [(48, 32), (200, 180), (70, 70), (100, 60)])
    outs = {}
    for side, fn, encode in (
            ('jax', jprep.prepare_latents, jencode),
            ('port', tprep.prepare_latents, tprep.make_encode_fn(vae, 'cpu'))):
        outs[side] = str(tmp_path_factory.mktemp(side))
        outs[side + '_counts'] = fn(root, encode, outs[side],
                                    target_len=TARGET_LEN, patch_size=2,
                                    log_every=0)
    return outs


def test_prepare_latents_equals_jax(prepared):
    assert prepared['port_counts'] == prepared['jax_counts'] == {
        'small': 2, 'large': 2}
    dirs = [f'from_16_to_{TARGET_LEN}', f'greater_than_{TARGET_LEN}_resize',
            f'greater_than_{TARGET_LEN}_crop']
    for d in dirs:
        names = sorted(os.listdir(osp.join(prepared['port'], d)))
        assert names == sorted(os.listdir(osp.join(prepared['jax'], d)))
        for name in names:
            got = safetensors_np.load_file(osp.join(prepared['port'], d, name))
            want = safetensors_np.load_file(osp.join(prepared['jax'], d, name))
            assert sorted(got) == sorted(want) == [
                'feature', 'grid', 'label', 'size']
            for k in ('grid', 'size', 'label'):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (d, name, k)
            assert got['feature'].shape == want['feature'].shape
            assert _rel(got['feature'], want['feature']) <= TOL


def test_patchify_inverts_unpatchify():
    mean = np.random.default_rng(0).standard_normal((2, 6, 4, 4)).astype(
        np.float32)
    feat = tprep.patchify_latent(mean, 2)
    assert np.array_equal(feat, jprep.patchify_latent(mean, 2))
    model = FiT(**TINY)
    back = model.unpatchify(torch.from_numpy(feat.reshape(2, 6, 16)), (6, 4),
                            channel_last=True)
    assert np.array_equal(back.numpy(), mean)


def test_prepared_shards_train_one_step(prepared):
    from fitv2_tpu_torch.data import INLatentLoader
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.train.train_step import (
        OptimizerConfig, create_train_state, make_train_step)
    from fitv2_tpu_torch.train.trainer import batch_to_device
    loader = INLatentLoader(prepared['port'], TARGET_LEN, 'random',
                            batch_size=2, num_workers=1, backend='python')
    batch = next(iter(loader.train_dataloader(2, 1, 0, 0)))
    assert batch['feature'].shape == (2, TARGET_LEN, 16)
    torch.manual_seed(0)
    model = FiT(**TINY)
    state = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, create_transport())
    _, metrics = step(state, batch_to_device(batch, torch.device('cpu')),
                      torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics['loss'])) and state.step == 1
