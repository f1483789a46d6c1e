"""Raw-image preprocessing and folder datasets.

The port's own copy of fitv2_tpu/data/imagenet.py: the ADM centre crop,
the aspect-preserving resize quantised to multiples of 16 px, the
class-per-folder ImageNet dataset, ``CustomDataset`` (image + precomputed
VAE-latent npy pairs for REPA raw-pixel encoders) and CIFAR-10 from its
pickle batches with the same PCG64 stream. Host-side numpy; PIL is
imported inside the functions that need it.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def center_crop_arr(pil_image, image_size: int) -> np.ndarray:
    """ADM centre crop: repeated 2x box-downsample until < 2*size, then
    bicubic to scale, then centre crop."""
    from PIL import Image
    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size),
        resample=Image.BICUBIC)
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def resize_arr(pil_image, max_size: int = 256, quant: int = 16
               ) -> np.ndarray:
    """Aspect-preserving resize with dims quantized to multiples of
    ``quant``."""
    from PIL import Image
    w, h = pil_image.size
    scale = max_size / max(w, h)
    w2, h2 = round(w * scale), round(h * scale)
    w2 = max(quant, (w2 // quant) * quant)
    h2 = max(quant, (h2 // quant) * quant)
    pil_image = pil_image.resize((w2, h2), resample=Image.BICUBIC)
    return np.array(pil_image)


def _find_images(root: str, exts=('.jpg', '.jpeg', '.png')) -> List[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(osp.join(dirpath, f))
    return sorted(out)


class ImagenetDataset:
    """class-per-folder ImageNet layout -> {jpg: HWC uint8, cls: int}."""

    def __init__(self, root: str, image_size: int = 256,
                 mode: str = 'center_crop'):
        self.root = root
        self.image_size = image_size
        self.mode = mode
        classes = sorted(d for d in os.listdir(root)
                         if osp.isdir(osp.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            for p in _find_images(osp.join(root, c)):
                self.samples.append((p, self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image
        path, cls = self.samples[idx]
        img = Image.open(path).convert('RGB')
        if self.mode == 'center_crop':
            arr = center_crop_arr(img, self.image_size)
        else:
            arr = resize_arr(img, self.image_size)
        return {'jpg': arr.astype(np.uint8), 'cls': np.int32(cls)}


class CustomDataset:
    """images/ + vae-sd/ npy pairs + dataset.json labels, for REPA
    raw-pixel training."""

    def __init__(self, data_dir: str):
        self.images_dir = osp.join(data_dir, 'images')
        self.features_dir = osp.join(data_dir, 'vae-sd')
        label_path = osp.join(self.images_dir, 'dataset.json')
        with open(label_path) as f:
            labels = json.load(f)['labels']
        labels = dict(labels)
        self.image_files = sorted(
            f for f in os.listdir(self.images_dir) if f.endswith('.npy'))
        self.feature_files = sorted(
            f for f in os.listdir(self.features_dir) if f.endswith('.npy'))
        if len(self.image_files) != len(self.feature_files):
            raise ValueError(
                f'{data_dir}: {len(self.image_files)} images but '
                f'{len(self.feature_files)} VAE features')
        self.labels = [int(labels[f.replace('\\', '/')])
                       if f.replace('\\', '/') in labels else 0
                       for f in self.image_files]

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int):
        img = np.load(osp.join(self.images_dir, self.image_files[idx]))
        feat = np.load(osp.join(self.features_dir, self.feature_files[idx]))
        return img, feat, np.int32(self.labels[idx])


def create_cifar10_arrays(root: str, train: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 from the extracted 'cifar-10-batches-py' pickle batches
    on disk. Returns (images uint8 NHWC, labels int32)."""
    import pickle
    base = osp.join(root, 'cifar-10-batches-py')
    files = ([f'data_batch_{i}' for i in range(1, 6)] if train
             else ['test_batch'])
    xs, ys = [], []
    for fname in files:
        with open(osp.join(base, fname), 'rb') as f:
            d = pickle.load(f, encoding='bytes')
        xs.append(d[b'data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[b'labels'], np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def cifar10_loader(root: str, batch_size: int, seed: int = 0,
                   train: bool = True, flip: bool = True):
    """Infinite shuffled CIFAR-10 batch generator (normalized to [-1,1]),
    the JAX package's PCG64 stream: a permutation per epoch, then each
    batch's flips."""
    images, labels = create_cifar10_arrays(root, train)
    rng = np.random.Generator(np.random.PCG64(seed))
    n = len(images)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            x = images[idx].astype(np.float32) / 127.5 - 1.0
            if flip:
                do = rng.random(batch_size) < 0.5
                x[do] = x[do, :, ::-1]
            yield {'image': x, 'label': labels[idx]}
