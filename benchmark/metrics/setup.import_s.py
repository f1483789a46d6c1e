"""Seconds from the process's start to torch imported (with the
harness's own modules): the part of set-up that only the host paces. The
CUDA context is made on a side thread meanwhile."""


def read(run):
    return run.clock.marks.get('torch_imported')
