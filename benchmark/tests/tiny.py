"""A cell of the manifest cut to a size the CPU runs in seconds: its
configuration at width 64, depth 2, its traffic at a few tokens and a
small batch. Only the tests use it; the limits stay the cell's own."""

from __future__ import annotations

import json
import os

import torch

from harness.cell import Cell, Run, load_json
from harness.common import Clock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SAMPLE = dict(batch=4, num_sampling_steps=6, image_size=[64, 64])


def tiny_run(workload: str, seed: int = 2 ** 40 + 7) -> Run:
    cell = Cell(load_json(os.path.join(ROOT, 'BENCHMARK.json')), workload)
    m = cell.config['model']
    m.update(hidden_size=64, depth=2, num_heads=4, adaln_lora_dim=16,
             context_size=16)
    if m.get('max_cached_len'):
        m['max_cached_len'] = 16
    cell.config['vae'].update(block_out_channels=[32, 32, 64, 64],
                              layers_per_block=1)
    cell.traffic = json.loads(json.dumps(cell.traffic))
    cell.traffic.update(SAMPLE)
    return Run(cell, seed, 0.05, False, Clock(), torch.device('cpu'), torch)
