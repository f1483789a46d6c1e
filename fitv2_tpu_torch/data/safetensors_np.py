"""A small numpy reader and writer of the safetensors format.

The latent shards are safetensors files; the port reads and writes them
itself, so it needs no ``safetensors`` package. The format: an 8-byte
little-endian header length, a JSON header mapping each tensor's name to
its ``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the byte
buffer that follows (an optional ``__metadata__`` entry holds strings),
then that buffer of raw little-endian values, C order.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np

# the dtypes of latent shards (as the native loader reads them; numpy has
# no bfloat16)
_DTYPES = {'F32': '<f4', 'F16': '<f2', 'I32': '<i4', 'I64': '<i8'}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, as numpy arrays."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f'{path}: too short for a safetensors header')
    (n,) = struct.unpack('<Q', data[:8])
    if 8 + n > len(data):
        raise ValueError(f'{path}: header length {n} past the end')
    header = json.loads(data[8:8 + n])
    buf = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        if info['dtype'] not in _DTYPES:
            raise ValueError(f'{path}: {name}: dtype {info["dtype"]} is not '
                             'read by this reader')
        begin, end = info['data_offsets']
        dtype = np.dtype(_DTYPES[info['dtype']])
        shape = tuple(info['shape'])
        if end > len(buf) or end - begin != dtype.itemsize * int(
                np.prod(shape, dtype=np.int64)):
            raise ValueError(f'{path}: {name}: data_offsets {begin, end} do '
                             f'not hold {shape} {info["dtype"]}')
        out[name] = np.frombuffer(buf[begin:end], dtype).reshape(shape).copy()
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write numpy arrays as a safetensors file (names in sorted order,
    the header padded with spaces to 8 bytes, as the reference writer
    does)."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        if a.dtype not in _NAMES:
            raise ValueError(f'{name}: dtype {a.dtype} is not written')
        raw = a.astype(a.dtype.newbyteorder('<'), copy=False).tobytes()
        header[name] = {'dtype': _NAMES[a.dtype], 'shape': list(a.shape),
                        'data_offsets': [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(',', ':')).encode()
    text += b' ' * (-len(text) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
