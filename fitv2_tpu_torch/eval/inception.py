"""InceptionV3 feature extractor for FID, sFID and the Inception Score.

Counterpart of fitv2_tpu/eval/inception.py: the FID-standard InceptionV3
(torchvision layout with pytorch-fid's pooling patches) with BatchNorm
folded into each convolution at import, so a layer is conv + bias + ReLU.
It runs as cuDNN convolutions in float32; ``compute_activations`` turns
TF32 off, which is what the JAX package computes.

  - pool3: (N, 2048) global average pool -> FID, precision / recall
  - spatial: the first 7 channels of Mixed_6e's output (17 x 17), flattened
    in NHWC order (the ADM evaluator's mixed_6/conv) -> sFID
  - logits: (N, 1008) -> softmax -> Inception Score

The public functions keep the JAX package's NHWC layout: images are uint8
(N, H, W, 3), the network's input (N, 299, 299, 3) in [-1, 1].

Weights: ``convert_inception_state_dict`` takes a torchvision / pytorch-fid
state dict; ``fitv2_tpu_torch.ckpt.inception_state_from_jax`` carries the
JAX package's parameters across. ``load_inception(None)`` is a seeded
torch initialisation: JAX's random-weights case is a flax init that torch
cannot reproduce, so the two packages' random-weights FIDs differ.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

BN_EPS = 1e-3
NUM_CLASSES = 1008  # the TF graph's classes
INIT_SEED = 0  # the random-weights case, as JAX's PRNGKey(0)


class ConvBN(nn.Module):
    """Conv + (folded BatchNorm) bias + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=True)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.conv(x))


def _avg_pool(x: Tensor) -> Tensor:
    """3x3 stride-1 average pool over the valid pixels only
    (count_include_pad=False, pytorch-fid's patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x: Tensor) -> Tensor:
    """3x3 stride-2 max pool without padding."""
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # Mixed_7c (pytorch-fid's E_2)
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.use_max_pool:  # 3x3 stride 1, padded with -inf
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class InceptionV3(nn.Module):
    """(N, 299, 299, 3) in [-1, 1] -> dict(pool3 (N, 2048), spatial
    (N, 2023), logits (N, num_classes)), float32."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC input
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        spatial = x[:, :7].permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool3 = x.mean(dim=(2, 3))
        return {'pool3': pool3, 'spatial': spatial, 'logits': self.fc(pool3)}


def preprocess_uint8(images: Tensor, size: int = 299) -> Tensor:
    """uint8 (N, H, W, 3) -> float32 (N, size, size, 3) in [-1, 1].

    Bilinear with half-pixel centres, antialiased on every axis it shrinks,
    as ``jax.image.resize(..., 'bilinear')`` is: the weights are JAX's
    (without antialiasing the result is off by up to 0.54 at 512x512)."""
    x = images.to(torch.float32) / 255.0
    if tuple(x.shape[1:3]) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode='bilinear', align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    return x * 2.0 - 1.0


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

_A = ('branch1x1', 'branch5x5_1', 'branch5x5_2', 'branch3x3dbl_1',
      'branch3x3dbl_2', 'branch3x3dbl_3', 'branch_pool')
_C = ('branch1x1', 'branch7x7_1', 'branch7x7_2', 'branch7x7_3',
      'branch7x7dbl_1', 'branch7x7dbl_2', 'branch7x7dbl_3', 'branch7x7dbl_4',
      'branch7x7dbl_5', 'branch_pool')
_E = ('branch1x1', 'branch3x3_1', 'branch3x3_2a', 'branch3x3_2b',
      'branch3x3dbl_1', 'branch3x3dbl_2', 'branch3x3dbl_3a',
      'branch3x3dbl_3b', 'branch_pool')
CONV_LAYERS: Tuple[str, ...] = (
    'Conv2d_1a_3x3', 'Conv2d_2a_3x3', 'Conv2d_2b_3x3', 'Conv2d_3b_1x1',
    'Conv2d_4a_3x3',
    *(f'{m}.{b}' for m in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d') for b in _A),
    *(f'Mixed_6a.{b}' for b in ('branch3x3', 'branch3x3dbl_1',
                                'branch3x3dbl_2', 'branch3x3dbl_3')),
    *(f'{m}.{b}' for m in ('Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e')
      for b in _C),
    *(f'Mixed_7a.{b}' for b in ('branch3x3_1', 'branch3x3_2',
                                'branch7x7x3_1', 'branch7x7x3_2',
                                'branch7x7x3_3', 'branch7x7x3_4')),
    *(f'{m}.{b}' for m in ('Mixed_7b', 'Mixed_7c') for b in _E))


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, Tensor) \
        else np.asarray(v)


def convert_inception_state_dict(sd: Mapping[str, object]
                                 ) -> Dict[str, Tensor]:
    """torchvision inception_v3 / pytorch-fid FIDInceptionV3 state dict
    (tensors or numpy arrays) -> this InceptionV3's state dict, each
    BatchNorm (eps 1e-3) folded into its convolution: w * g / sqrt(var +
    eps), b - mean * g / sqrt(var + eps), computed in the arrays' dtype as
    the JAX package's converter does."""
    out: Dict[str, Tensor] = {}
    for name in CONV_LAYERS:
        w = _np(sd[f'{name}.conv.weight'])
        g, b, mean, var = (_np(sd[f'{name}.bn.{k}']) for k in (
            'weight', 'bias', 'running_mean', 'running_var'))
        scale = g / np.sqrt(var + BN_EPS)
        out[f'{name}.conv.weight'] = torch.from_numpy(np.ascontiguousarray(
            w * scale[:, None, None, None], np.float32))
        out[f'{name}.conv.bias'] = torch.from_numpy(np.ascontiguousarray(
            b - mean * scale, np.float32))
    for k in ('fc.weight', 'fc.bias'):
        out[k] = torch.from_numpy(np.array(_np(sd[k]), np.float32))
    return out


def random_fid_state_dict(seed: int = 0) -> Dict[str, Tensor]:
    """A seeded pytorch-fid-layout state dict (convolutions without bias,
    BatchNorm with random affine and running statistics, fc), for tests
    and smoke runs where no real weights file exists."""
    gen = torch.Generator().manual_seed(seed)
    shapes = {k[:-len('.weight')]: v.shape
              for k, v in InceptionV3().state_dict().items()
              if k.endswith('.conv.weight')}
    sd: Dict[str, Tensor] = {}
    for conv, shape in shapes.items():
        name = conv[:-len('.conv')]
        fan_in = shape[1] * shape[2] * shape[3]
        o = shape[0]
        sd[f'{conv}.weight'] = torch.randn(shape, generator=gen) \
            * (2.0 / fan_in) ** 0.5
        sd[f'{name}.bn.weight'] = 0.5 + torch.rand(o, generator=gen)
        sd[f'{name}.bn.bias'] = 0.05 * torch.randn(o, generator=gen)
        sd[f'{name}.bn.running_mean'] = 0.05 * torch.randn(o, generator=gen)
        sd[f'{name}.bn.running_var'] = 0.5 + torch.rand(o, generator=gen)
    sd['fc.weight'] = torch.randn(NUM_CLASSES, 2048, generator=gen) \
        * 2048 ** -0.5
    sd['fc.bias'] = torch.zeros(NUM_CLASSES)
    return sd


def _seeded_init(model: InceptionV3) -> None:
    """lecun-normal weights (std sqrt(1 / fan_in)) and zero biases from a
    generator seeded with ``INIT_SEED``: the flax defaults' distribution,
    not their draw."""
    gen = torch.Generator().manual_seed(INIT_SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * fan_in ** -0.5)
                m.bias.zero_()


def load_inception(weights_path: Optional[str] = None,
                   device: torch.device | str = 'cuda') -> InceptionV3:
    """InceptionV3 in eval mode on ``device``. With a weights file (a
    torchvision / pytorch-fid state dict, .safetensors or .pt/.bin), its
    BatchNorm folded; without, the seeded initialisation (tests and
    development only: its FID has no external meaning, and differs from
    the JAX package's random-weights FID)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('InceptionV3 on cuda but no CUDA device is '
                           'available')
    model = InceptionV3()
    if weights_path is not None:
        from fitv2_tpu_torch.ckpt.torch_import import load_torch_state_dict
        model.load_state_dict(convert_inception_state_dict(
            load_torch_state_dict(weights_path)))
    else:
        _seeded_init(model)
    return model.to(device=device, memory_format=torch.channels_last).eval()


@contextlib.contextmanager
def _fp32_exact():
    """cuDNN convolutions and matmuls in full float32 (no TF32), restored
    on exit."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@torch.no_grad()
def compute_activations(model: InceptionV3, images_uint8: np.ndarray,
                        batch_size: int = 64) -> Dict[str, np.ndarray]:
    """uint8 (N, H, W, 3) -> float32 numpy pool3 (N, 2048), spatial
    (N, 2023) and softmax (N, 1008), on the model's device, batch by batch
    (the last batch as it is: no padding)."""
    device = next(model.parameters()).device
    outs: Dict[str, list] = {'pool3': [], 'spatial': [], 'softmax': []}
    with _fp32_exact():
        for i in range(0, images_uint8.shape[0], batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                images_uint8[i:i + batch_size])).to(device)
            res = model(preprocess_uint8(chunk))
            outs['pool3'].append(res['pool3'].cpu().numpy())
            outs['spatial'].append(res['spatial'].cpu().numpy())
            outs['softmax'].append(
                torch.softmax(res['logits'], dim=-1).cpu().numpy())
    return {k: np.concatenate(v) for k, v in outs.items()}

