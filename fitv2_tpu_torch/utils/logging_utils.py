"""Metric logging: a stdout tee and JSONL metrics, TensorBoard and wandb
where installed and asked for.

Counterpart of fitv2_tpu/utils/logging_utils.py. JSONL is always written;
the other writers are skipped when their package is absent.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class Tee:
    """Mirror stdout to a file."""

    def __init__(self, path: str):
        self.file = open(path, 'a')
        self.stdout = sys.stdout
        sys.stdout = self

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)

    def flush(self):
        self.file.flush()
        self.stdout.flush()

    def close(self):
        sys.stdout = self.stdout
        self.file.close()


class MetricLogger:
    """``metrics.jsonl`` under ``output_dir``, one record a call; also
    TensorBoard (``torch.utils.tensorboard``) and wandb when importable and
    asked for."""

    def __init__(self, output_dir: str, use_tensorboard: bool = True,
                 use_wandb: bool = False, project: str = 'fitv2_tpu',
                 run_name: Optional[str] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl = open(os.path.join(output_dir, 'metrics.jsonl'), 'a')
        self.tb = None
        self.wandb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(os.path.join(output_dir, 'tb'))
            except ImportError:
                pass
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb.init(project=project, name=run_name,
                                        dir=output_dir)
            except Exception:
                self.wandb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {'step': step, 'time': time.time(), **metrics}
        self.jsonl.write(json.dumps(rec) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, v, step)
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.flush()
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
