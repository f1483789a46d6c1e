"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by plain ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into one shared library with a C interface, which
is loaded with ``ctypes``. The build directory ``kernels/_build/<hash>/`` is keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: the first
kernel launch on a CUDA tensor builds the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

# dtype codes of the C entry points (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG / '_build'
LIB_NAME = 'libfitv2_kernels.so'
COMPILE_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
                 '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LINK_FLAGS = ('-shared',)


def sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels cannot be built')


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(' '.join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in ('.cu', '.cuh'):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet.

    Returns its path and nvcc's report (register and shared-memory use of
    each kernel; empty when the library was already built). Each source
    compiles in its own ``nvcc`` process, all at once; every process is
    waited for before the link or the error. The library is linked under a
    temporary name and renamed, so a build that is cut off never leaves a
    half-written library behind.
    """
    out = library_path()
    if out.exists():
        return out, ''
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objdir = tempfile.mkdtemp(dir=out.parent)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out.parent)
    os.close(fd)
    jobs = []
    try:
        for src in sources():
            obj = os.path.join(objdir, src.stem + '.o')
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, '-c', '-o', obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        report, failed = [], []
        for src, _, proc in jobs:
            stdout, stderr = proc.communicate()
            report.append(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f'{src.name} ({proc.returncode}):\n{stdout}\n'
                              f'{stderr}')
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        res = subprocess.run([nvcc, *LINK_FLAGS, '-o', tmp,
                              *(obj for _, obj, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                               f'{res.stdout}\n{res.stderr}')
        os.replace(tmp, out)
    finally:
        for _, _, proc in jobs:  # none outlives the build, even on an error
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(objdir, ignore_errors=True)
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, ''.join(report) + res.stdout + res.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    return ctypes.CDLL(str(path))


@functools.cache
def function(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared; returns cudaError_t.

    Pointers and the stream must be ``c_void_p`` (ctypes would otherwise
    pass a Python int as a 32-bit int and cut the pointer)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream_and_dtype(*tensors) -> tuple[int, int]:
    """Validate that kernel operands share one CUDA device (the current one)
    and one dtype of the library's (float32 or bfloat16); returns the raw
    current stream and the library's dtype code."""
    dev = tensors[0].device
    if dev.type != 'cuda':
        raise ValueError(f'kernel operands must be CUDA tensors, got {dev}')
    if any(t.device != dev for t in tensors):
        raise ValueError('kernel operands lie on different devices: '
                         f'{[str(t.device) for t in tensors]}')
    if dev.index != torch.cuda.current_device():
        raise ValueError(f'operands on {dev} but the current device is '
                         f'cuda:{torch.cuda.current_device()}')
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError('kernel operands must all be float32 or all bfloat16,'
                        f' got {[t.dtype for t in tensors]}')
    return torch.cuda.current_stream(dev).cuda_stream, DTYPE_CODES[dtype]


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (launch refused etc.)."""
    if err != 0:
        describe = library().fitv2_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f'{name}: CUDA error {err} ({describe(err).decode()})')
