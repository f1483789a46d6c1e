"""Rotating training checkpoints with milestones and deterministic resume.

Counterpart of fitv2_tpu/ckpt/checkpoint.py (orbax there): each save is a
``checkpoint-{step}/`` directory holding ``train_state.pt`` (the trainer
state's ``state_dict()`` through ``torch.save``). It is written into a
temporary directory beside it and renamed into place, so a directory named
``checkpoint-{step}`` is always whole. Rotation keeps the newest
``total_limit`` saves plus every milestone step. A checkpoint that cannot
be read raises: nothing re-initialises silently.

Under model sharding the trainers write the one-process layout whatever
the mesh (parallel/sharding.py ``ShardedLayout.full_state_dict``:
process 0 gathers it), and every rank restores its shards from it
(``restore(..., mmap=True)`` maps the file instead of reading it), so a
checkpoint moves between meshes and to one process.

``async_save=True`` overlaps the write with training, as JAX's orbax
async path does: ``save`` takes a host copy of the state dict on the
calling thread, then writes it from one background thread; ``wait()``
joins that write (re-raising its error) and rotates. ``save`` and
``restore`` wait for a write in flight first, and rotation runs only after
a write has finished, so it counts whole checkpoints only.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from typing import Any, List, Optional, Sequence

import torch

_CKPT_RE = re.compile(r'^checkpoint-(\d+)$')
STATE_FILE = 'train_state.pt'


def list_checkpoints(ckpt_dir: str) -> List[int]:
    """The steps of the whole checkpoints under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _host_copy(obj: Any) -> Any:
    """``obj`` (nested dicts, lists and tuples) with every tensor copied to
    the host: a snapshot that later in-place updates do not reach."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, ckpt_dir: str, total_limit: Optional[int] = None,
                 milestone_steps: Sequence[int] = (),
                 async_save: bool = False):
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.total_limit = total_limit
        self.milestones = set(milestone_steps)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f'checkpoint-{step}')

    def save(self, step: int, state_dict: Any) -> str:
        """Write ``state_dict`` as checkpoint-{step} (replacing one of that
        step), then rotate; async, start writing a host copy of it and
        return (rotation follows the write, at the next save or wait)."""
        self.wait()
        if not self.async_save:
            self._write(step, state_dict)
            self._rotate()
            return self.path(step)
        snapshot = _host_copy(state_dict)
        self._writer = threading.Thread(
            target=self._write_in_background, args=(step, snapshot),
            name=f'checkpoint-{step}')
        self._writer.start()
        return self.path(step)

    def _write(self, step: int, state_dict: Any) -> None:
        final = self.path(step)
        tmp = tempfile.mkdtemp(prefix=f'.checkpoint-{step}-',
                               dir=self.ckpt_dir)
        try:
            torch.save(state_dict, os.path.join(tmp, STATE_FILE))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _write_in_background(self, step: int, state_dict: Any) -> None:
        try:
            self._write(step, state_dict)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Block until a write in flight is whole, then rotate; a failed
        write raises here."""
        if self._writer is None:
            return
        self._writer.join()
        self._writer = None
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(f'async checkpoint write failed: {error}'
                               ) from error
        self._rotate()

    def _rotate(self) -> None:
        if self.total_limit is None:
            return
        steps = [s for s in list_checkpoints(self.ckpt_dir)
                 if s not in self.milestones]
        for s in steps[:max(0, len(steps) - self.total_limit)]:
            shutil.rmtree(self.path(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                map_location: Any = None, mmap: bool = False) -> Any:
        """The state_dict saved at ``step`` (default: the latest). Raises
        FileNotFoundError when there is none and the loader's error when
        it cannot be read. A write in flight finishes first. ``mmap``
        maps the file instead of reading it (a sharded trainer's ranks
        each take their shards of it)."""
        self.wait()
        if step is None:
            step = latest_checkpoint_step(self.ckpt_dir)
            if step is None:
                raise FileNotFoundError(f'no checkpoint under {self.ckpt_dir}')
        path = os.path.join(self.path(step), STATE_FILE)
        try:
            return torch.load(path, map_location=map_location,
                              weights_only=True, mmap=mmap)
        except Exception as e:
            raise RuntimeError(f'unreadable checkpoint {path}: {e}') from e
