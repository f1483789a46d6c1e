"""The harness's arithmetic: operations, roofline bounds, statistics and
the reductions of a traced window, on known numbers."""

import math
import statistics

import numpy as np
import pytest

from harness import common, flops
from harness.cell import load_json
from harness.trace import Trace, union

from tiny import ROOT


def config(name):
    return load_json(f'{ROOT}/benchmark/configs/{name}.json')


@pytest.mark.parametrize('name, n, per_token', [
    ('fitv2-xl-2', 256, 1.19e9), ('fitv2-hr-xl-2', 1024, 1.32e9)])
def test_forward_flops_per_token(name, n, per_token):
    # 15.93 M parameters of per-token products a block, 36 blocks, plus
    # attention's 4 n D a token a block
    cfg = config(name)
    block = 2 * (4 * 1152 ** 2 + 3 * 1152 * 3072)
    assert block == 2 * 15_925_248
    got = flops.fit_forward_flops(cfg, [n]) / n
    assert got == pytest.approx(per_token, rel=0.01)
    assert got > 36 * (block + 4 * n * 1152)


def test_sample_flops_per_image():
    cfg = config('fitv2-xl-2')
    per_image = 250 * flops.fit_forward_flops(cfg, [256, 256])
    assert per_image == pytest.approx(1.52e14, rel=0.01)
    decode = flops.vae_decode_flops(cfg['vae'], 32, 32)
    assert 5e11 < decode < 8e11     # ~0.4% of an image's operations


def test_roofline_bounds_at_the_cells_shapes():
    # K4 at CFG batch 16 (PERF.md's kernel table): 37.7 MB, bytes-bound
    assert flops.attention_call_bound_s(16, 16, 256, 72) == pytest.approx(
        37.7e6 / 3.35e12, rel=0.01)
    # at the sample cells' CFG batches
    xl = flops.attention_call_bound_s(64, 16, 256, 72)
    assert xl == pytest.approx(4 * 64 * 256 * 1152 * 2 / 3.35e12)
    hr = flops.attention_call_bound_s(16, 16, 1024, 72)
    assert hr == pytest.approx(4 * 16 * 16 * 1024 ** 2 * 72 / 989e12)
    # K1: 18.9 MB at CFG batch 16
    assert flops.adaln_call_bound_s(16, 256, 1152) == pytest.approx(
        18.9e6 / 3.35e12, rel=0.01)


def test_spread():
    vals = [10.0, 10.2, 9.9, 10.1, 10.0, 10.3]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert common.spread(vals) == pytest.approx(
        (q3 - q1) / statistics.median(vals))


def test_derived_seeds_take_large_seeds():
    big = 2 ** 33 + 5
    assert common.derive_seed(big, 1) != common.derive_seed(big, 2)
    assert 0 <= common.derive_seed(big, 1) < 2 ** 63


def synthetic_trace():
    # window 0-100 ns on thread 1; kernels on [10, 30] and [20, 40] (one
    # overlapping pair), [60, 70] launched from thread 2, a copy [80, 85]
    dev = [('k_a', 10, 30, 0, 1, 5), ('k_b', 20, 40, 0, 1, 15),
           ('k_c', 60, 70, 0, 2, 55), ('Memcpy HtoD', 80, 85, 1, 1, 75)]
    host = [('bench.window', 0, 100, 1), ('aten::mm', 40, 60, 1),
            ('bench.vae_decode', 50, 80, 1)]
    return Trace(dev, host)


def test_trace_busy_idle_and_attribution():
    t = synthetic_trace()
    assert union([(10, 30), (20, 40), (60, 70)]) == [[10, 40], [60, 70]]
    assert t.busy_ns() == 30 + 10 + 5
    assert 1 - t.busy_ns() / t.window_ns() == pytest.approx(0.55)
    # of the launches inside the decode's range, k_c's came from another
    # thread: the copy alone counts
    assert t.ranges('bench.vae_decode') == [(50, 80)]
    assert t.busy_ns(t.launched_within(t.ranges('bench.vae_decode'))) == 5
    assert t.named('k_', exclude=('k_b',)).tolist() == [0, 2]
    b = t.breakdown(top=2)
    assert b['device_ops'][0] == ['k_a', 20e-9]
    # the longest gap, 40-60, began inside aten::mm
    assert b['idle_gaps'][0] == ['aten::mm', 20e-9]
    assert math.isclose(sum(s for _, s in t.breakdown()['idle_gaps']),
                        55e-9)


def test_image_gaps():
    from harness.compare import image_gaps
    a = np.zeros((2, 32, 32, 3), np.uint8)
    b = a.copy()
    b[1, :16, :16] = 20
    gaps = image_gaps(b, a, 16)
    assert gaps['patch_gap_max'] == 20
    assert gaps['pixel_gap_mean'] == pytest.approx(20 / 8)


class FakeEvent:
    def __init__(self, name, device, start, dur, thread=1, corr=0):
        self._v = (name, device, start, dur, thread, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def test_kineto_events_to_trace():
    from harness.trace import from_kineto
    CPU, CUDA = 'cpu', 'cuda'
    events = [FakeEvent('bench.window', CPU, 0, 100),
              FakeEvent('bench.window', CUDA, 5, 90),    # its device mirror
              FakeEvent('cudaLaunchKernel', CPU, 4, 1, thread=2, corr=7),
              FakeEvent('kern', CUDA, 10, 20, corr=7),
              FakeEvent('Memcpy HtoD', CUDA, 40, 5, corr=8)]
    t = from_kineto(events, CUDA)
    assert t.dev_name == ['kern', 'Memcpy HtoD']
    assert t.busy_ns() == 25
    # each interval keeps its launch's host thread and time, where the
    # runtime call was recorded
    assert t.dev[0, 3:].tolist() == [2.0, 4.0]
    assert t.dev[1, 3:].tolist() == [-1.0, -1.0]
