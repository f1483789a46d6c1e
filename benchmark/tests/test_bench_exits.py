"""A run that cannot measure exits with another code than 0 and prints no
result: here on a host with no card (the CUDA context's side thread finds
no libcuda and gives way), from a checkout that holds only the manifest and
the benchmark's folder."""

import os
import shutil
import subprocess
import sys

from tiny import ROOT


def test_no_card_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'xl-sample-b32',
         '--seed', str(2 ** 31 + 11), '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA device' in proc.stderr
