"""PyTorch port, slice 8a (item 23): GAN-guided LwD training -- bias_act and
upfirdn2d (``kernels/``), the perceptual and GAN losses (``losses/``), the
generator / discriminator steps (``train/gan_train_step.py``) and
``cli/train_cifar_gan`` -- against the JAX package on the same numpy
inputs and weights (JAX's trees carried by ``disc_state_from_jax``,
``lpips_state_from_jax`` and ``lwd_state_from_jax``).

Tolerances (fp32 on both sides; the frameworks sum and convolve in other
orders, and differ by transcendental ulps):
- bias_act and its gradients: 1e-6 of the largest magnitude;
- upfirdn2d and its wrappers: 1e-6 of the largest magnitude;
- the D losses, adopt_weight and the adaptive weight: 1e-6 relative;
- the discriminators' logits, input gradient and running statistics:
  1e-5 of the largest magnitude (convolutions summed in other orders);
- LPIPS: 1e-5 relative (13 VGG convolutions);
- the GAN steps: test_torch_port_lwd_train's rules (losses 1e-5 relative;
  moments 1e-4 of their scale; parameters and EMA within 2e-6 except where
  Adam's first step turns a gradient near eps into a visible move: at most
  1% of the elements, none more than 2 lr an update); the discriminator's
  parameters, statistics and Adam state likewise;
- the CLI against itself: bit for bit.
"""

import importlib
import math
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fitv2_tpu.losses import perceptual as jp
from fitv2_tpu.models.fit_lwd import FiTLwD as JFiTLwD
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.train import gan_train_step as jgan
from fitv2_tpu.train import train_step as jts

from fitv2_tpu_torch.ckpt import (
    disc_state_from_jax, lpips_state_from_jax, lwd_state_from_jax)
from fitv2_tpu_torch.cli import train_cifar_gan
from fitv2_tpu_torch.kernels import bias_act as pba
from fitv2_tpu_torch.kernels import upfirdn2d as pup
from fitv2_tpu_torch.losses import perceptual as pp
from fitv2_tpu_torch.models import FiTLwD
from fitv2_tpu_torch.train import (
    OptimizerConfig, create_disc_state, create_train_state, disc_adam,
    make_gan_steps)
from fitv2_tpu_torch.train.lwd_train_step import _segment_params

from test_torch_port_int8_lwd import jax_tree
from test_torch_port_lwd import randomize
from test_torch_port_lwd_train import LR, TOL_LOSS, TOL_MOMENT, TOL_PARAM
from test_torch_port_lwd_train import _compare

# the modules (``fitv2_tpu.ops`` exports functions of the same names)
jba = importlib.import_module('fitv2_tpu.ops.bias_act')
jup = importlib.import_module('fitv2_tpu.ops.upfirdn2d')

NO_OPT = {'xla_backend_optimization_level': 0}
TOL = 1e-6
TOL_CONV = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scaled(a, b):
    """max |a - b| over the largest |b|."""
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- bias_act -----------------------------------------------------------------

@pytest.mark.parametrize('act', sorted(jba.ACTIVATION_FUNCS))
def test_bias_act_matches_jax(act):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 4)).astype(np.float32) * 2
    b = rng.standard_normal(5).astype(np.float32)
    cases = [dict(), dict(b=b), dict(b=b, gain=0.7, clamp=0.5),
             dict(alpha=0.3, clamp=-1.0), dict(b=b[:4], dim=3, gain=2.0)]
    for kw in cases:
        jb = None if 'b' not in kw else jnp.asarray(kw['b'])
        pb = None if 'b' not in kw else torch.from_numpy(kw['b'])
        rest = {k: v for k, v in kw.items() if k != 'b'}
        ref = np.asarray(jba.bias_act(jnp.asarray(x), jb, act=act, **rest))
        out = pba.bias_act(torch.from_numpy(x), pb, act=act, **rest)
        assert _scaled(out, ref) <= TOL, (act, kw)
    with pytest.raises(ValueError):
        pba.bias_act(torch.from_numpy(x), act='gelu_nope')


@pytest.mark.parametrize('act', ['lrelu', 'swish', 'elu'])
def test_bias_act_second_order_grad_matches_jax(act):
    """d/dx of sum((d/dx sum(bias_act(x + b)))^2): a second-order gradient
    through autograd against JAX's."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)

    def jfn(x):
        g = jax.grad(lambda v: jnp.sum(jba.bias_act(
            v, jnp.asarray(b), act=act, dim=1, gain=1.3)))(x)
        return jnp.sum(g ** 2)
    ref = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = pba.bias_act(xt, torch.from_numpy(b), act=act, dim=1, gain=1.3)
    (g,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), xt)
    assert _scaled(gg, ref) <= TOL


# -- upfirdn2d ----------------------------------------------------------------

_FILTERS = {
    'box': ([1., 1.], {}),
    'binomial': ([1., 3., 3., 1.], {}),
    'flipped_2d': (np.arange(6, dtype=np.float32).reshape(2, 3) + 1,
                   dict(flip_filter=True)),
    'separable': ([1., 2., 3., 4., 4., 3., 2., 1.], {}),
    'gain': ([1., 2., 1.], dict(gain=2.0)),
}
_UPFIRDN = [(up, down, pad) for up, down, pad in (
    (1, 1, 0), (2, 1, 1), (1, 2, 1), (2, 2, 2), ((2, 1), (1, 2), (1, 2)),
    (1, 1, (2, 0, 1, 3)), (2, 1, (-1, 2, 0, -2)), (1, 2, (-2, -1, 1, 0)))]


@pytest.mark.parametrize('name', sorted(_FILTERS))
def test_setup_filter_and_upfirdn2d_match_jax(name):
    taps, kw = _FILTERS[name]
    jf = np.asarray(jup.setup_filter(taps, **kw))
    pf = pup.setup_filter(taps, **kw)
    assert pf.dtype == torch.float32 and np.array_equal(pf.numpy(), jf)
    x = np.random.default_rng(2).standard_normal((2, 3, 11, 13)).astype(
        np.float32)
    # flipping changes only an asymmetric filter's values
    flips = (False, True) if name == 'flipped_2d' else (False,)
    for up, down, pad in _UPFIRDN:
        for flip in flips:
            ref = np.asarray(jup.upfirdn2d(
                jnp.asarray(x), jnp.asarray(jf), up=up, down=down,
                padding=pad, flip_filter=flip, gain=1.5))
            out = pup.upfirdn2d(torch.from_numpy(x), pf, up=up, down=down,
                                padding=pad, flip_filter=flip, gain=1.5)
            assert out.shape == ref.shape, (up, down, pad)
            assert _scaled(out, ref) <= TOL, (name, up, down, pad, flip)


@pytest.mark.parametrize('wrapper', ['upsample2d', 'downsample2d',
                                     'filter2d', 'upfirdn2d_none'])
def test_resampling_wrappers_match_jax(wrapper):
    x = np.random.default_rng(3).standard_normal((1, 2, 8, 6)).astype(
        np.float32)
    for taps in ([1., 3., 3., 1.], [1., 2., 1.], np.ones((2, 3))):
        jf = jup.setup_filter(taps)
        pf = pup.setup_filter(taps)
        for pad in (0, 1, (1, 0, 2, 1)):
            if wrapper == 'upfirdn2d_none':
                ref = jup.upfirdn2d(jnp.asarray(x), None, up=2, padding=pad)
                out = pup.upfirdn2d(torch.from_numpy(x), None, up=2,
                                    padding=pad)
            else:
                ref = getattr(jup, wrapper)(jnp.asarray(x), jf, padding=pad)
                out = getattr(pup, wrapper)(torch.from_numpy(x), pf,
                                            padding=pad)
            assert out.shape == ref.shape
            assert _scaled(out, np.asarray(ref)) <= TOL, (wrapper, pad)


def test_upfirdn2d_gradient_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2, 5, 6)).astype(np.float32)
    w = rng.standard_normal((1, 2, 10, 12)).astype(np.float32)
    f = jup.setup_filter([1., 3., 3., 1.])
    ref = jax.grad(lambda v: jnp.sum(jup.upsample2d(v, f) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (pup.upsample2d(xt, pup.setup_filter([1., 3., 3., 1.]))
     * torch.from_numpy(w)).sum().backward()
    assert _scaled(xt.grad, np.asarray(ref)) <= TOL


# -- the losses ---------------------------------------------------------------

def test_d_losses_and_weights_match_jax():
    rng = np.random.default_rng(5)
    lr_, lf = (rng.standard_normal((4, 3, 3, 1)).astype(np.float32) * 2
               for _ in range(2))
    for name in ('hinge_d_loss', 'vanilla_d_loss'):
        ref = float(getattr(jp, name)(jnp.asarray(lr_), jnp.asarray(lf)))
        out = float(getattr(pp, name)(torch.from_numpy(lr_),
                                      torch.from_numpy(lf)))
        assert abs(out - ref) <= TOL * abs(ref), name
    for step in (0, 4, 5, 9):
        ref = float(jp.adopt_weight(0.7, jnp.asarray(step), threshold=5,
                                    value=0.1))
        assert float(pp.adopt_weight(0.7, step, threshold=5,
                                     value=0.1)) == ref
        assert float(pp.adopt_weight(0.7, torch.tensor(step), 5)) == float(
            jp.adopt_weight(0.7, jnp.asarray(step), 5))
    g1, g2 = (rng.standard_normal((6, 5)).astype(np.float32)
              for _ in range(2))
    for scale in (1.0, 1e-9, 1e6):
        ref = float(jp.calculate_adaptive_weight(
            jnp.asarray(g1), jnp.asarray(g2) * scale, 0.5))
        out = float(pp.calculate_adaptive_weight(
            torch.from_numpy(g1), torch.from_numpy(g2) * scale, 0.5))
        assert abs(out - ref) <= TOL * abs(ref), scale
    cfg_j = jp.LPIPSWithDiscriminator2D(disc_start=3, disc_weight=0.3)
    cfg_p = pp.LPIPSWithDiscriminator2D(disc_start=3, disc_weight=0.3)
    nll = rng.standard_normal(4).astype(np.float32)
    for step in (2, 3):
        ref = float(cfg_j.discriminator_loss(jnp.asarray(lr_),
                                             jnp.asarray(lf), step))
        out = float(cfg_p.discriminator_loss(torch.from_numpy(lr_),
                                             torch.from_numpy(lf), step))
        assert abs(out - ref) <= TOL * max(abs(ref), 1e-12)
        ref = float(cfg_j.generator_loss(jnp.asarray(lf), jnp.asarray(nll),
                                         0.8, step))
        out = float(cfg_p.generator_loss(torch.from_numpy(lf),
                                         torch.from_numpy(nll), 0.8, step))
        assert abs(out - ref) <= TOL * abs(ref)
    imgs = [rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
            for _ in range(2)]
    for pixel in ('l1', 'l2'):
        ref = cfg_j.__class__(pixel_loss=pixel).reconstruction_loss(
            None, *map(jnp.asarray, imgs))
        out = cfg_p.__class__(pixel_loss=pixel).reconstruction_loss(
            None, *map(torch.from_numpy, imgs))
        assert _scaled(out, np.asarray(ref)) <= TOL


# -- the discriminators -------------------------------------------------------

@pytest.fixture(scope='module')
def discs():
    """{dims: (JAX disc, its variables (params randomised, batch stats
    moved off their init), port disc carrying them, input shape)}."""
    out = {}
    for dims, jcls, pcls, shape in (
            (2, jp.NLayerDiscriminator, pp.NLayerDiscriminator,
             (3, 16, 16, 3)),
            (3, jp.NLayerDiscriminator3D, pp.NLayerDiscriminator3D,
             (2, 5, 16, 16, 3))):
        jd = jcls(input_nc=3, ndf=8, n_layers=2)
        shapes = jax.eval_shape(lambda k, x: jd.init(k, x, train=True),
                                jax.random.PRNGKey(0), jnp.zeros(shape))
        params = randomize(shapes['params'], seed=dims, scale=0.2)
        rng = np.random.default_rng(dims)
        stats = jax.tree_util.tree_map(
            lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(
                np.float32)), shapes['batch_stats'])
        pd = pcls(input_nc=3, ndf=8, n_layers=2)
        pd.load_state_dict(disc_state_from_jax(_np(params), _np(stats)),
                           strict=True)
        out[dims] = (jd, {'params': params, 'batch_stats': stats}, pd,
                     shape)
    return out


@pytest.mark.parametrize('dims', [2, 3])
def test_discriminator_matches_jax(discs, dims):
    """Logits in train and eval mode, the input gradient, and the running
    statistics after a train forward (flax's momentum 0.99 with the biased
    batch variance)."""
    jd, variables, pd, shape = discs[dims]
    x = np.random.default_rng(10 + dims).uniform(-1, 1, shape).astype(
        np.float32)

    def jfwd(x):
        return jd.apply(variables, x, train=True, mutable=['batch_stats'])

    def everything(x, w):
        (out, mut), vjp = jax.vjp(jfwd, x)
        grad = vjp((w, jax.tree_util.tree_map(jnp.zeros_like, mut)))[0]
        return out, mut, grad, jd.apply(variables, x, train=False)
    w = np.random.default_rng(20).standard_normal(jax.eval_shape(
        jfwd, jnp.asarray(x))[0].shape).astype(np.float32)
    ref, mut, ref_grad, ref_eval = jax.jit(
        everything, compiler_options=NO_OPT)(jnp.asarray(x), jnp.asarray(w))

    pd = pd.__class__(input_nc=3, ndf=8, n_layers=2)
    pd.load_state_dict(disc_state_from_jax(
        _np(variables['params']), _np(variables['batch_stats'])))
    xt = torch.from_numpy(x).requires_grad_()
    before = {k: v.clone() for k, v in pd.state_dict().items()}
    frozen = pd(xt, train=True, update_stats=False)
    assert all(torch.equal(v, pd.state_dict()[k]) for k, v in before.items())
    out = pd(xt, train=True)
    assert torch.equal(out, frozen)
    assert out.shape == ref.shape
    assert _scaled(out, np.asarray(ref)) <= TOL_CONV
    (out * torch.from_numpy(w)).sum().backward()
    assert _scaled(xt.grad, np.asarray(ref_grad)) <= TOL_CONV
    new = disc_state_from_jax(_np(variables['params']),
                              _np(mut['batch_stats']))
    for name in new:
        if name.endswith(('running_mean', 'running_var')):
            assert _scaled(pd.state_dict()[name], new[name]) <= TOL_CONV, \
                name
    with torch.no_grad():
        pd.load_state_dict(disc_state_from_jax(
            _np(variables['params']), _np(variables['batch_stats'])))
        assert _scaled(pd(xt, train=False), np.asarray(ref_eval)) <= TOL_CONV


def test_flax_init_statistics():
    """The port's initialisation is flax's: lecun_normal kernels (variance
    1 / fan_in), zero biases, BatchNorm at (1, 0, 0, 1)."""
    torch.manual_seed(0)
    d = pp.NLayerDiscriminator(input_nc=3, ndf=64, n_layers=3)
    w = d.conv3.weight.detach()
    assert abs(w.std().item() * math.sqrt(w[0].numel()) - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 / math.sqrt(w[0].numel()) / .8796 + 1e-6
    assert not d.conv0.bias.any() and not d.conv_out.bias.any()
    assert torch.equal(d.bn1.running_var, torch.ones(128))
    assert torch.equal(d.bn1.weight, torch.ones(128))


# -- LPIPS --------------------------------------------------------------------

@pytest.fixture(scope='module')
def lpips_jax():
    lp = jp.LPIPS()
    shapes = jax.eval_shape(lp.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 32, 32, 3)))['params']
    fn = jax.jit(lambda p, x, y: lp.apply({'params': p}, x, y),
                 compiler_options=NO_OPT)
    return shapes, fn


def _lpips_inputs():
    rng = np.random.default_rng(30)
    return [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2)]


def test_lpips_matches_jax(lpips_jax):
    shapes, fn = lpips_jax
    params = randomize(shapes, seed=31, scale=0.05)
    # taming's heads are non-negative, so the distance is
    params = {k: jax.tree_util.tree_map(jnp.abs, v) if k.startswith('lin')
              else v for k, v in params.items()}
    x, y = _lpips_inputs()
    ref = np.asarray(fn(params, x, y))
    model = pp.LPIPS()
    model.load_state_dict(lpips_state_from_jax(_np(params)), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (2,) and (ref > 0).all()
    assert _scaled(out, ref) <= TOL_CONV


def test_convert_lpips_state_dict_matches_jax(lpips_jax):
    """A random state dict in taming's layout through both converters."""
    _, fn = lpips_jax
    rng = np.random.default_rng(32)
    sd, cin = {}, 3
    convs = [v for v in jp._VGG16_CFG if v != 'M']
    idx = [i for s in range(1, 6) for i in pp._TORCH_SLICE_CONVS[s]]
    for s, (i, c) in zip((s for s in range(1, 6)
                          for _ in pp._TORCH_SLICE_CONVS[s]),
                         zip(idx, convs)):
        sd[f'net.slice{s}.{i}.weight'] = rng.standard_normal(
            (c, cin, 3, 3)).astype(np.float32) * 0.05
        sd[f'net.slice{s}.{i}.bias'] = rng.standard_normal(c).astype(
            np.float32) * 0.05
        cin = c
    for i, c in enumerate(pp._LPIPS_CHANNELS):
        sd[f'lin{i}.model.1.weight'] = rng.uniform(
            0, 0.1, (1, c, 1, 1)).astype(np.float32)
    x, y = _lpips_inputs()
    ref = np.asarray(fn(jp.convert_lpips_state_dict(sd), x, y))
    model = pp.LPIPS()
    model.load_state_dict(pp.convert_lpips_state_dict(sd), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(y))
    assert _scaled(out, ref) <= TOL_CONV


# -- the generator and discriminator steps ------------------------------------

GEN = dict(context_size=64, patch_size=2, in_channels=3, hidden_size=32,
           depth=2, num_heads=2, num_classes=10, number_of_perflow=2,
           n_patch_h=8, n_patch_w=8, adaln_type='lora', adaln_lora_dim=8,
           max_cached_len=8, class_dropout_prob=0.5)
GAN_B = 4


def _patchify(img):
    """The example's patchify, at 16 x 16 pixels."""
    b = img.shape[0]
    x = img.reshape(b, 8, 2, 8, 2, 3)
    return jnp.einsum('bhpwqc->bhwcpq', x).reshape(b, 64, 12)


def _unpatchify(tok):
    b = tok.shape[0]
    x = tok.reshape(b, 8, 8, 3, 2, 2)
    return jnp.einsum('bhwcpq->bhpwqc', x).reshape(b, 16, 16, 3)


def _gan_batch():
    rng = np.random.default_rng(40)
    return dict(image=rng.uniform(-1, 1, (GAN_B, 16, 16, 3)).astype(
                    np.float32),
                label=np.array([1, 4, 7, 9]),
                x0=rng.standard_normal((GAN_B, 64, 12)).astype(np.float32),
                r=rng.uniform(size=GAN_B).astype(np.float32),
                drop=np.array([1, 0, 0, 1]))


def _jax_gen_loss(jm, k, grid, size):
    """The example's segment loss with its draws (x0, r, the label drops)
    read from the batch."""
    sig = jm.sigmas
    s_cur, s_next = float(sig[k]), float(sig[k + 1])
    mask = jnp.ones(grid.shape[:1] + grid.shape[2:])

    def fn(params, batch, rng):
        x1 = _patchify(batch['image'])
        x0, r = batch['x0'], batch['r']
        xt_in = x0 * (1 - s_cur) + x1 * s_cur
        xt = x0 * (1 - s_next) + x1 * s_next
        t_input = s_cur + r * (s_next - s_cur)
        x_input = xt_in * (1 - r[:, None, None]) + xt * r[:, None, None]
        target = (xt - xt_in) / (s_next - s_cur)
        pred, _ = jm.apply({'params': params}, x_input, t_input,
                           batch['label'], k, grid, mask, size, True,
                           batch['drop'], method=jm.forward_run_layer)
        loss = jnp.mean((pred - target) ** 2)
        fake = _unpatchify(x_input + (s_next - s_cur) * pred)
        return loss, jnp.clip(fake, -1, 1)
    return fn


@pytest.fixture(scope='module')
def generator():
    """The JAX generator and its randomised params (the tree's layout from
    the port model's ``ckpt.jax_leaves``: no traced init)."""
    return JFiTLwD(**GEN), jax_tree(FiTLwD(**GEN), seed=41)


@pytest.mark.parametrize('segment,disc_start', [(0, 0), (1, 5)])
def test_gan_steps_match_jax(discs, generator, segment, disc_start):
    """One gen_step + disc_step: the losses, the generator's params, EMA
    and Adam state, and the discriminator's params, statistics and Adam
    state. disc_start 5 leaves the adversarial terms at factor 0."""
    jm, params = generator
    g, _, s = j_grid(GAN_B, 8, 8, 64)
    jd, dvars, _, _ = discs[2]
    gen_tx = jts.make_optimizer(jts.OptimizerConfig(learning_rate=LR))
    disc_tx = optax.adam(LR, b1=0.5, b2=0.9)
    loss_j = jp.LPIPSWithDiscriminator2D(disc_start=disc_start,
                                         disc_weight=0.1)
    gen_j, disc_j = jgan.make_gan_steps(
        _jax_gen_loss(jm, segment, g, s), jd, gen_tx, disc_tx, loss_j,
        ema_decay=0.9)
    init = jts.create_train_state(params, gen_tx)
    dstate = jgan.DiscState(step=jnp.zeros((), jnp.int32),
                            params=dvars['params'],
                            batch_stats=dvars['batch_stats'],
                            opt_state=disc_tx.init(dvars['params']))
    batch = _gan_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gen_loss_j = _jax_gen_loss(jm, segment, g, s)

    def both(init, dstate, jb):
        jstate, jgm = gen_j(init, dstate, jb, jax.random.PRNGKey(0))
        jfake = gen_loss_j(jstate.params, jb, None)[1]
        jdstate, jdm = disc_j(dstate, jb['image'], jfake, jstate.step)
        return jstate, jgm, jdstate, jdm
    jstate, jgm, jdstate, jdm = jax.jit(both, compiler_options=NO_OPT)(
        init, dstate, jb)

    model = FiTLwD(**GEN)
    model.load_state_dict(lwd_state_from_jax(_np(params), model),
                          strict=True)
    disc = pp.NLayerDiscriminator(input_nc=3, ndf=8, n_layers=2)
    disc.load_state_dict(disc_state_from_jax(_np(dvars['params']),
                                             _np(dvars['batch_stats'])))
    state = create_train_state(model, OptimizerConfig(learning_rate=LR))
    pdstate = create_disc_state(disc, lambda p: disc_adam(p, LR))
    loss_p = pp.LPIPSWithDiscriminator2D(disc_start=disc_start,
                                         disc_weight=0.1)
    gen_loss = train_cifar_gan.make_generator_loss(model, GAN_B, 'cpu')
    gen_p, disc_p = make_gan_steps(gen_loss, model, loss_p, ema_decay=0.9,
                                   required=_segment_params(model))
    pb = dict(image=torch.from_numpy(batch['image']),
              label=torch.from_numpy(batch['label']))
    draws = dict(x0=torch.from_numpy(batch['x0']),
                 r=torch.from_numpy(batch['r']),
                 drop_ids=torch.from_numpy(batch['drop']))
    stats0 = {k: v.clone() for k, v in disc.state_dict().items()
              if 'running' in k}
    state, pgm = gen_p(state, pdstate, pb, None, draws, segment_idx=segment)
    # the generator step leaves D's statistics and gradients alone
    assert all(torch.equal(v, disc.state_dict()[k])
               for k, v in stats0.items())
    assert all(p.grad is None for p in disc.parameters())
    with torch.no_grad():
        _, fake = gen_loss(model, pb, None, draws, segment)
    pdstate, pdm = disc_p(pdstate, pb['image'], fake, state.step)

    for k in ('loss', 'base_loss', 'g_loss'):
        assert abs(float(pgm[k]) - float(jgm[k])) <= TOL_LOSS * max(
            abs(float(jgm[k])), 1e-12), k
    assert abs(float(pdm['d_loss']) - float(jdm['d_loss'])) <= TOL_LOSS * \
        max(abs(float(jdm['d_loss'])), 1e-12)
    if disc_start:
        assert float(pgm['loss']) == float(pgm['base_loss'])
        assert float(pdm['d_loss']) == 0.0
    _compare(state, jax.device_get(jstate), jax.device_get(init), model)

    # the discriminator: params, running statistics, Adam's moments
    jd_np = jax.device_get(jdstate)
    new = disc_state_from_jax(jd_np.params, jd_np.batch_stats)
    adam = jd_np.opt_state[0]
    mu = disc_state_from_jax(adam.mu, {})
    nu = disc_state_from_jax(adam.nu, {})
    assert pdstate.step == int(jd_np.step) == 1
    for name, t in disc.state_dict().items():
        diff = (t - new[name]).abs()
        if 'running' in name:
            assert _scaled(t, new[name]) <= TOL_CONV, name
        else:
            assert diff.max() <= 2 * LR, name
            assert (diff > TOL_PARAM).float().mean() <= 0.01, name
    for name, p in disc.named_parameters():
        st = pdstate.optimizer.state[p]
        assert _scaled(st['mu'], mu[name]) <= TOL_MOMENT or \
            np.abs(mu[name].numpy()).max() == 0, name
        assert _scaled(st['nu'], nu[name]) <= TOL_MOMENT or \
            np.abs(nu[name].numpy()).max() == 0, name
    assert pdstate.optimizer.param_groups[0]['count'] == int(adam.count)


# -- the CLI ------------------------------------------------------------------

def _synthetic_cifar(root, n=16, seed=0):
    d = os.path.join(root, 'cifar-10-batches-py')
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(1, 6):
        with open(os.path.join(d, f'data_batch_{i}'), 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b'labels': list(rng.integers(0, 10, n))}, f)


def test_cli_train_cifar_gan_repeats_bit_for_bit(tmp_path, capsys):
    """Two CPU runs of two steps, with the adversarial terms live from the
    first step: finite losses and BatchNorm statistics, bit-identical."""
    _synthetic_cifar(str(tmp_path))
    argv = ['--cifar', str(tmp_path), '--device', 'cpu', '--batch', '2',
            '--steps', '2', '--disc-start', '0', '--seed', '5']
    runs = [train_cifar_gan.main(argv) for _ in range(2)]
    assert 'step 0: gen=' in capsys.readouterr().out
    a, b = ([{k: v for k, v in r.items() if k != 'ms'} for r in run['history']]
            for run in runs)
    assert len(a) == 2 and a == b
    for rec in a:
        assert all(np.isfinite(v) for v in rec.values())
        assert rec['g_loss'] != 0.0 and rec['d_loss'] != 0.0
    for (n, t), (_, u) in zip(runs[0]['disc_state'].disc.state_dict().items(),
                              runs[1]['disc_state'].disc.state_dict().items()):
        assert torch.isfinite(t).all() and torch.equal(t, u), n
    for n, t in runs[0]['state'].params.items():
        assert torch.equal(t, runs[1]['state'].params[n]), n
    with pytest.raises(RuntimeError, match='CUDA') if not \
            torch.cuda.is_available() else _nothing():
        train_cifar_gan.main(['--cifar', str(tmp_path), '--steps', '0'])


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_patchify_round_trip_matches_jax():
    img = np.random.default_rng(50).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    tok = train_cifar_gan.patchify(torch.from_numpy(img))
    jx = jnp.asarray(img).reshape(2, 16, 2, 16, 2, 3)
    ref = jnp.einsum('bhpwqc->bhwcpq', jx).reshape(2, 256, 12)
    assert np.array_equal(tok.numpy(), np.asarray(ref))
    assert torch.equal(train_cifar_gan.unpatchify(tok), torch.from_numpy(img))
