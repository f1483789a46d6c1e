"""Rotating training checkpoints with milestones and deterministic resume.

Counterpart of fitv2_tpu/ckpt/checkpoint.py (orbax there): each save is a
``checkpoint-{step}/`` directory holding ``train_state.pt`` (the trainer
state's ``state_dict()`` through ``torch.save``). It is written into a
temporary directory beside it and renamed into place, so a directory named
``checkpoint-{step}`` is always whole. Rotation keeps the newest
``total_limit`` saves plus every milestone step. A checkpoint that cannot
be read raises: nothing re-initialises silently. Async saves are not
ported.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
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


class CheckpointManager:
    def __init__(self, ckpt_dir: str, total_limit: Optional[int] = None,
                 milestone_steps: Sequence[int] = (),
                 async_save: bool = False):
        if async_save:
            raise NotImplementedError(
                'async checkpoint saves are not ported; saves block')
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.total_limit = total_limit
        self.milestones = set(milestone_steps)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f'checkpoint-{step}')

    def save(self, step: int, state_dict: Any) -> str:
        """Write ``state_dict`` as checkpoint-{step} (replacing one of that
        step), then rotate."""
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
        self._rotate()
        return final

    def _rotate(self) -> None:
        if self.total_limit is None:
            return
        steps = [s for s in list_checkpoints(self.ckpt_dir)
                 if s not in self.milestones]
        for s in steps[:max(0, len(steps) - self.total_limit)]:
            shutil.rmtree(self.path(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                map_location: Any = None) -> Any:
        """The state_dict saved at ``step`` (default: the latest). Raises
        FileNotFoundError when there is none and the loader's error when
        it cannot be read."""
        if step is None:
            step = latest_checkpoint_step(self.ckpt_dir)
            if step is None:
                raise FileNotFoundError(f'no checkpoint under {self.ckpt_dir}')
        path = os.path.join(self.path(step), STATE_FILE)
        try:
            return torch.load(path, map_location=map_location,
                              weights_only=True)
        except Exception as e:
            raise RuntimeError(f'unreadable checkpoint {path}: {e}') from e
