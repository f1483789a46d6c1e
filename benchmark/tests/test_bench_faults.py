"""A run of each cell with the look for a card skipped and the timed path
broken underneath comes out not correct under the cell's own limits, once
for each fault the cell can have. The controls, the reference in float8,
come out not correct. A sound sampling run comes out correct. All at a
tiny size on the CPU (the port's plain kernels)."""

import pytest

from harness import common
from harness.compare import image_gaps
from tiny import tiny_run

SAMPLE_CELLS = ('xl-sample-b32', 'hrxl-sample-b8')


def correct(run) -> bool:
    run.cell.kind().run(run)
    return common.all_within(common.judge(run.compared, run.cell.limits))


def state_unchanged_sampler(monkeypatch):
    from fitv2_tpu_torch.sample import pipeline
    monkeypatch.setattr(pipeline, 'euler_sample',
                        lambda fn, z, sigmas, return_trajectory=False: z)


def half_batch_sampler(monkeypatch):
    from fitv2_tpu_torch.sample import pipeline
    build = pipeline.build_sampler

    def broken(*args, **kwargs):
        fn = build(*args, **kwargs)

        def sample_fn(labels, **kw):
            out = fn(labels, **kw)
            out[out.shape[0] // 2:] = 0
            return out
        return sample_fn
    monkeypatch.setattr(pipeline, 'build_sampler', broken)


def altered_answer(monkeypatch):
    from fitv2_tpu_torch.sample import pipeline
    to_uint8 = pipeline.images_to_uint8

    def broken(images):
        out = to_uint8(images)
        out[:, :16, :16] = 255 - out[:, :16, :16]   # one token's footprint
        return out
    monkeypatch.setattr(pipeline, 'images_to_uint8', broken)


@pytest.mark.parametrize('cell', SAMPLE_CELLS)
def test_sound_sampling_run_is_correct(cell):
    assert correct(tiny_run(cell))


@pytest.mark.parametrize('fault', [state_unchanged_sampler,
                                   half_batch_sampler, altered_answer])
@pytest.mark.parametrize('cell', SAMPLE_CELLS)
def test_sampling_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not correct(tiny_run(cell))


@pytest.mark.parametrize('cell', SAMPLE_CELLS)
def test_sampling_control_is_not_correct(cell):
    run = tiny_run(cell)
    kind = run.cell.kind()
    _, rows = kind.compared_rows(run, 1)
    ref = kind.reference_images(run, 0, rows)
    control = kind.reference_images(run, 0, rows, lowp=True)
    gaps = image_gaps(control, ref, 16)
    assert not common.all_within(common.judge(gaps, run.cell.limits))
