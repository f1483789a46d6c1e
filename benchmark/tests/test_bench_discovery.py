"""A configuration, a traffic mix and a metric dropped into their folders
are found by name from a manifest entry, without editing another file."""

import json
import os
import shutil

import pytest

from harness.cell import Cell, load_json
from tiny import ROOT

BENCH = os.path.join(ROOT, 'benchmark')


@pytest.fixture
def copy(tmp_path):
    dst = tmp_path / 'benchmark'
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    return dst


def test_new_files_are_found_by_name(copy):
    manifest = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cfg = load_json(copy / 'configs' / 'fitv2-xl-2.json')
    cfg['name'] = 'fitv2-xl-2-copy'
    (copy / 'configs' / 'fitv2-xl-2-copy.json').write_text(json.dumps(cfg))
    tr = load_json(copy / 'traffic' / 'sample-256-b32.json')
    tr.update(name='sample-256-b16', batch=16)
    (copy / 'traffic' / 'sample-256-b16.json').write_text(json.dumps(tr))
    (copy / 'limits' / 'xl-sample-b16.json').write_text(
        json.dumps({'limits': {'pixel_gap_mean': 1.0}}))
    (copy / 'metrics' / 'batches.sample.py').write_text(
        'def read(run):\n    return run.values.get("batches")\n')
    manifest['configs'].append(dict(manifest['configs'][0],
                                    name='fitv2-xl-2-copy'))
    manifest['workloads'].append(dict(
        name='xl-sample-b16', config='fitv2-xl-2-copy',
        traffic='sample-256-b16', chips=1, why='a test'))
    manifest['per_layer'].append(dict(
        name='batches.sample', unit='batches', better='higher',
        source='host_clock', layer='sampler loop',
        moves='sample_img_per_s', workloads=['xl-sample-b16']))
    cell = Cell(manifest, 'xl-sample-b16', bench_dir=str(copy))
    assert cell.config['name'] == 'fitv2-xl-2-copy'
    assert cell.traffic['batch'] == 16
    assert cell.limits == {'pixel_gap_mean': 1.0}
    assert cell.kind().__name__ == 'bench_kind_sample'
    names = [m['name'] for m in cell.metrics(traced=True)]
    assert 'batches.sample' in names and 'vae_decode_ms.sample' not in names

    class R:
        values = {'batches': 3}
    assert cell.reader('batches.sample').read(R) == 3
    # the cells already there are unchanged
    old = Cell(manifest, 'xl-sample-b32', bench_dir=str(copy))
    assert old.traffic['batch'] == 32


def test_every_manifest_name_has_its_files():
    manifest = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    for w in manifest['workloads']:
        cell = Cell(manifest, w['name'])
        assert cell.limits, w['name']
        assert cell.traffic['name'] == w['traffic']
        assert cell.config['name'] == w['config']
        for traced in (False, True):
            for m in cell.metrics(traced):
                assert hasattr(cell.reader(m['name']), 'read'), m['name']
    for c in manifest['configs']:
        assert os.path.exists(os.path.join(ROOT, c['file']))
