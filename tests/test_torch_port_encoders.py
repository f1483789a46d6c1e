"""PyTorch port, item 22: the REPA teachers (fitv2_tpu_torch.encoders:
ViT, DINOv2, CLIP), their preprocessing and ``load_encoders``, against the
goldens' torch twins and the JAX package on the same weights and numpy
inputs.

Sizes: the goldens' (DINOv2: 28 px, patch 7, width 48, depth 3, 2 register
tokens, the fused SwiGLU MLP; CLIP: 32 px, patch 8, width 64, depth 3) and
a ViT of width 64.

Tolerances: tokens 1e-5 of their largest magnitude (fp32 products summed
in other orders); the cubic resize of the position embedding 1e-6 of its
largest magnitude against ``jax.image.resize`` (the same weights, the
contraction in another order); ``F.interpolate``'s bicubic misses it by
far more, which the test shows.
"""

import os.path as osp

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from fitv2_tpu.encoders import preprocess_raw_image as j_preprocess
from fitv2_tpu.encoders.clip import CLIPVisionTransformer as JCLIP
from fitv2_tpu.encoders.dinov2 import DinoV2ViT as JDinoV2
from fitv2_tpu.encoders.vit import VisionTransformer as JViT

from fitv2_tpu_torch.ckpt import teacher_state_from_jax
from fitv2_tpu_torch.encoders import (
    CLIPVisionTransformer, DinoV2ViT, VisionTransformer,
    convert_clip_visual_state_dict, convert_dinov2_state_dict, load_encoders,
    preprocess_raw_image, resize_cubic)

GOLDENS = osp.join(osp.dirname(__file__), 'goldens')
TOL = 1e-5
DINO = dict(img_size=28, patch_size=7, embed_dim=48, depth=3, num_heads=4,
            num_register_tokens=2, swiglu_ffn=True)
CLIP = dict(image_size=32, patch_size=8, width=64, depth=3, num_heads=4,
            output_dim=48)
VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _golden(name):
    g = np.load(osp.join(GOLDENS, f'{name}.npz'))
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files
          if k.startswith('sd:')}
    return g, sd


def test_dinov2_matches_golden():
    g, sd = _golden('dinov2')
    model = DinoV2ViT(**DINO).eval()
    model.load_state_dict(convert_dinov2_state_dict(sd), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(g['x'].transpose(0, 2, 3, 1)))
    assert out.shape == (2, 16, 48)
    assert _rel(out, g['tokens']) <= TOL


def test_clip_matches_golden():
    g, sd = _golden('clip')
    model = CLIPVisionTransformer(**CLIP).eval()
    model.load_state_dict(convert_clip_visual_state_dict(sd), strict=True)
    x = torch.from_numpy(g['x'].transpose(0, 2, 3, 1))
    with torch.no_grad():
        tokens, pooled = model(x)
        feats = model.forward_features(x)
    assert _rel(tokens, g['tokens']) <= TOL
    assert _rel(pooled, g['pooled']) <= TOL
    assert torch.equal(feats, tokens[:, 1:])


def _jax_params(jm, shape, seed=0):
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros(shape))['params']
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.05 * (
        rng.standard_normal(v.shape).astype(np.float32)), params)


@pytest.mark.parametrize('family,hw', [
    ('vit', (32, 32)), ('clip', (32, 32)),
    ('dinov2', (28, 28)),   # the learned grid as it is
    ('dinov2', (56, 42)),   # 4 x 4 -> 8 x 6: up-sampled
    ('dinov2', (14, 21)),   # 4 x 4 -> 2 x 3: down-sampled, antialiased
])
def test_teacher_matches_jax(family, hw):
    jm, pm = {'vit': (JViT(**VIT), VisionTransformer(**VIT)),
              'clip': (JCLIP(**CLIP), CLIPVisionTransformer(**CLIP)),
              'dinov2': (JDinoV2(**DINO), DinoV2ViT(**DINO))}[family]
    init_hw = (28, 28) if family == 'dinov2' else (32, 32)
    params = _jax_params(jm, (1, *init_hw, 3))
    pm.load_state_dict(teacher_state_from_jax(params), strict=True)
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = jax.jit(jm.apply)({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    for a, b in zip(got if family == 'clip' else [got],
                    want if family == 'clip' else [want]):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize('shape', [(37, 37, 5, 16, 16), (4, 4, 3, 8, 6),
                                   (4, 4, 3, 2, 3), (6, 9, 2, 9, 4)])
def test_cubic_resize_matches_jax(shape):
    h, w, c, oh, ow = shape
    x = np.random.default_rng(0).standard_normal((h, w, c)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (oh, ow, c),
                                       method='cubic'))
    got = resize_cubic(torch.from_numpy(x), oh, ow)
    assert _rel(got, want) <= 1e-6
    if (h, w) == (37, 37):  # DINOv2-B/14's 37 x 37 grid to 224 px's 16 x 16
        naive = F.interpolate(torch.from_numpy(x).permute(2, 0, 1)[None],
                              size=(oh, ow), mode='bicubic',
                              align_corners=False)[0].permute(1, 2, 0)
        assert _rel(naive, want) > 1e-2


def test_preprocess_equals_jax():
    x = np.random.default_rng(0).integers(0, 255, (2, 8, 8, 3), np.uint8)
    for enc in ('dinov2-vit-b', 'clip', 'mae'):
        want = np.asarray(j_preprocess(jnp.asarray(x), enc))
        got = preprocess_raw_image(torch.from_numpy(x), enc)
        assert _rel(got, want) <= 1e-6


def test_load_encoders(tmp_path):
    """Seeded random teachers of each family at their real shapes; a local
    state dict (DINOv2 with register tokens, a whole OpenAI CLIP
    checkpoint) loads into the model it describes."""
    x = torch.zeros(1, 224, 224, 3)
    for enc, arch, n in (('dinov2-vit-b', 'vit_base', 256),
                         ('clip-vit-b', 'vit_base', 196),
                         ('mae-vit-b', 'vit_base', 196)):
        model, pre = load_encoders(enc, arch=arch)
        again, _ = load_encoders(enc, arch=arch)
        for (k, v), (_, w) in zip(model.state_dict().items(),
                                  again.state_dict().items()):
            assert torch.equal(v, w), k
        with torch.no_grad():
            out = (model.forward_features(pre(x)) if enc.startswith('clip')
                   else model(pre(x)))
        assert out.shape == (1, n, 768) and torch.isfinite(out).all()
    # a DINOv2-S/14 hub file with 4 register tokens and keys the port
    # drops; an OpenAI CLIP checkpoint with its text tower
    src = DinoV2ViT(embed_dim=384, depth=12, num_heads=6,
                    num_register_tokens=4)
    path = str(tmp_path / 'dino.pt')
    torch.save(dict(src.state_dict(), mask_token=torch.zeros(1, 384),
                    **{'head.weight': torch.zeros(2, 384)}), path)
    model, _ = load_encoders('dinov2', path, arch='vit_small')
    assert model.num_register_tokens == 4
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    g, sd = _golden('clip')
    path = str(tmp_path / 'clip.pt')
    torch.save(dict(sd, **{'transformer.resblocks.0.ln_1.weight':
                           torch.zeros(3)}), path)
    with pytest.raises(RuntimeError):  # the golden's widths are not B/16's
        load_encoders('clip', path)
    assert set(convert_clip_visual_state_dict(torch.load(path))) == set(
        CLIPVisionTransformer(**CLIP).state_dict())
