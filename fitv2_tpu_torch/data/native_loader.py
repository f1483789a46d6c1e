"""ctypes bridge to the C++ latent-shard loader (native/latent_loader.cc).

The library parses each shard's safetensors header, copies the chosen flip
variant and zero-pads feature, grid and mask to the target length, in a
C++ thread pool. It has a plain C ABI, so the port shares it with the JAX
package: g++ builds it on first use from the repository's source into
``fitv2_tpu_torch/data/_build/<hash of the source>/`` (never into
``native/``). A failed build or load raises; nothing falls back to the
Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, 'native', 'latent_loader.cc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_build')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the library for the current source is built."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, digest, 'liblatent_loader.so')


def _build(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++', '-O3', '-std=c++17', '-shared', '-fPIC',
                        '-pthread', SOURCE, '-o', tmp],
                       check=True, capture_output=True, text=True,
                       timeout=300)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f'building {SOURCE} failed:\n{e.stderr}') from e
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """The loader library, built first if needed. Raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.ll_load_batch.restype = ctypes.c_int
        lib.ll_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_batch(paths: Sequence[str], flips: Sequence[int], target_len: int,
               channels: int = 16, num_threads: int = 8
               ) -> Dict[str, np.ndarray]:
    """Assemble a padded batch natively: feature (n, L, C) f32, grid
    (n, 2, L) i32, mask (n, L) f32, label (n,) i32, size (n, 1, 2) i32.
    Raises when a shard cannot be read."""
    lib = load_library()
    n = len(paths)
    feature = np.empty((n, target_len, channels), np.float32)
    grid = np.empty((n, 2, target_len), np.int32)
    mask = np.empty((n, target_len), np.float32)
    label = np.empty((n,), np.int32)
    size = np.empty((n, 2), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_flips = (ctypes.c_int * n)(*[int(f) for f in flips])
    ok = lib.ll_load_batch(
        c_paths, c_flips, n, target_len, channels, num_threads,
        _ptr(feature, ctypes.c_float), _ptr(grid, ctypes.c_int32),
        _ptr(mask, ctypes.c_float), _ptr(label, ctypes.c_int32),
        _ptr(size, ctypes.c_int32))
    if ok != n:
        raise RuntimeError(f'native loader: {n - ok}/{n} shards failed')
    return {'feature': feature, 'grid': grid, 'mask': mask, 'label': label,
            'size': size.reshape(n, 1, 2)}

