"""CLI: encode an image folder into FiT latent shards with the port's VAE.

Counterpart of tools/prepare_latents.py, with the same layout, shard names
and keys, so ``cli/train`` and ``cli/train_lwd`` read its output:

  out_dir/from_16_to_{L}/            images whose native grid (16 px
                                     quantised) fits in L tokens, encoded
                                     at their quantised native size
  out_dir/greater_than_{L}_resize/   larger images, aspect-preserving
                                     ``resize_arr`` to the max side
  out_dir/greater_than_{L}_crop/     the same larger images, square
                                     ``center_crop_arr``, under the same
                                     file name as their resize version

Each shard: ``feature`` (2, gh, gw, p*p*C) float32, the unflipped and
horizontally flipped scaled VAE posterior means in the model's (c, ph, pw)
token order (the inverse of ``FiT.unpatchify``); ``grid`` (2, N) int32;
``size`` (2,) int32 = (gh, gw); ``label`` () int32.

The work is split in two: ``encode_routed`` routes and encodes decoded
uint8 arrays (no PIL), and ``prepare_latents`` is the image-folder front
end that decodes and resizes with PIL.

Usage:
    python -m fitv2_tpu_torch.cli.prepare_latents --images DIR \
        --vae sd-vae-ft-ema.safetensors --out datasets/in1k_latents_256 \
        [--target-len 256] [--patch-size 2] [--max-images N] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from fitv2_tpu_torch.data.safetensors_np import save_file
from fitv2_tpu_torch.models.grid_utils import make_grid
from fitv2_tpu_torch.vae.autoencoder_kl import SD_VAE_SCALE

# (B, H, W, 3) float32 in [-1, 1] -> (B, H/8, W/8, C) scaled latent means
EncodeFn = Callable[[np.ndarray], np.ndarray]
# (name, label, (width, height), arrays): arrays(kind) -> the uint8 HWC
# image for kind 'native' (the quantised native size) or 'resize' / 'crop'
Sample = Tuple[str, int, Tuple[int, int], Callable[[str], np.ndarray]]


def patchify_latent(mean: np.ndarray, patch_size: int) -> np.ndarray:
    """(B, lh, lw, C) latent -> (B, gh, gw, C*p*p) tokens in the model's
    (c, ph, pw) order, the inverse of ``FiT.unpatchify``."""
    p = patch_size
    b, lh, lw, c = mean.shape
    gh, gw = lh // p, lw // p
    feat = mean.reshape(b, gh, p, gw, p, c).transpose(0, 1, 3, 5, 2, 4)
    return feat.reshape(b, gh, gw, c * p * p)


def quantized_native_tokens(width: int, height: int, token_px: int = 16
                            ) -> int:
    """Token count of the native image after multiple-of-16 px
    quantisation (a token is patch_size * 8 = 16 px at p 2)."""
    return max(1, width // token_px) * max(1, height // token_px)


def bucket_dirs(out_dir: str, target_len: int) -> Dict[str, str]:
    """The three bucket directories under ``out_dir``."""
    return {'native': osp.join(out_dir, f'from_16_to_{target_len}'),
            'resize': osp.join(out_dir, f'greater_than_{target_len}_resize'),
            'crop': osp.join(out_dir, f'greater_than_{target_len}_crop')}


def encode_and_write(img_u8: np.ndarray, cls: int, encode_fn: EncodeFn,
                     out_path: str, patch_size: int) -> None:
    """Encode the [unflipped, flipped] pair of one image; write its shard."""
    img = img_u8.astype(np.float32) / 127.5 - 1.0            # HWC [-1, 1]
    both = np.stack([img, img[:, ::-1]])                      # flip the W axis
    feat = patchify_latent(np.asarray(encode_fn(both)), patch_size)
    gh, gw = feat.shape[1], feat.shape[2]
    save_file({'feature': feat.astype(np.float32),
               'grid': make_grid(gh, gw).astype(np.int32),
               'size': np.array([gh, gw], np.int32),
               'label': np.array(int(cls), np.int32)}, out_path)


def encode_routed(samples: Iterable[Sample], encode_fn: EncodeFn,
                  out_dir: str, target_len: int = 256, patch_size: int = 2,
                  log_every: int = 100) -> Dict[str, int]:
    """Route each sample by its native size and write its shards: at the
    quantised native size if that grid fits ``target_len`` tokens, else
    both the resize and the crop version under one name. Returns the
    counts of 'small' and 'large' images."""
    dirs = bucket_dirs(out_dir, target_len)
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    counts = {'small': 0, 'large': 0}
    for i, (name, cls, (w, h), arrays) in enumerate(samples):
        if quantized_native_tokens(w, h) <= target_len:
            kinds, key = ('native',), 'small'
        else:
            kinds, key = ('resize', 'crop'), 'large'
        for kind in kinds:
            encode_and_write(arrays(kind), cls, encode_fn,
                             osp.join(dirs[kind], name), patch_size)
        counts[key] += 1
        if log_every and i % log_every == 0:
            print(f'{i} images', flush=True)
    return counts


def make_encode_fn(vae, device: torch.device | str) -> EncodeFn:
    """``encode_fn`` of the port's AutoencoderKL on ``device``: the
    posterior mean times SD_VAE_SCALE, as float32 numpy."""
    def encode(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            mean, _ = vae.encode(torch.from_numpy(
                np.ascontiguousarray(x)).to(device))
            return (mean.float() * SD_VAE_SCALE).cpu().numpy()
    return encode


def prepare_latents(images_root: str, encode_fn: EncodeFn, out_dir: str,
                    target_len: int = 256, patch_size: int = 2,
                    max_images: int = None, log_every: int = 100
                    ) -> Dict[str, int]:
    """Every image of a class-per-folder tree through ``encode_routed``
    (PIL decodes; large images get a resize to the max side and an ADM
    centre crop). Shards are named by the image's index."""
    from PIL import Image

    from fitv2_tpu_torch.data.imagenet import (
        ImagenetDataset, center_crop_arr, resize_arr)

    max_side = int(np.sqrt(target_len)) * patch_size * 8
    ds = ImagenetDataset(images_root, image_size=max_side, mode='resize')
    n = min(len(ds), max_images or len(ds))

    def samples():
        for i in range(n):
            path, cls = ds.samples[i]
            pil = Image.open(path).convert('RGB')
            prep = {'native': lambda: resize_arr(pil, max_size=max(pil.size)),
                    'resize': lambda: resize_arr(pil, max_size=max_side),
                    'crop': lambda: center_crop_arr(pil, max_side)}
            yield (f'{i:06d}.safetensors', cls, pil.size,
                   lambda kind, prep=prep: prep[kind]())

    return encode_routed(samples(), encode_fn, out_dir, target_len,
                         patch_size, log_every)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='encode images into FiT '
                                            'latent shards (PyTorch)')
    p.add_argument('--images', required=True, help='class-per-folder root')
    p.add_argument('--vae', required=True,
                   help='diffusers SD-VAE .safetensors / .bin / .pt')
    p.add_argument('--out', required=True)
    p.add_argument('--target-len', type=int, default=256)
    p.add_argument('--patch-size', type=int, default=2)
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from fitv2_tpu_torch.vae import AutoencoderKL, load_vae_state_dict
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError(f'device {args.device!r}: no CUDA card; pass '
                           '--device cpu')
    vae = AutoencoderKL()
    vae.load_state_dict(load_vae_state_dict(args.vae))
    vae = vae.to(args.device).eval()
    counts = prepare_latents(args.images, make_encode_fn(vae, args.device),
                             args.out, target_len=args.target_len,
                             patch_size=args.patch_size,
                             max_images=args.max_images)
    print('done:', args.out, counts)


if __name__ == '__main__':
    main()
