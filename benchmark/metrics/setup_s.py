"""Seconds from the process's start (read from /proc before torch is
imported) to the first timed step or batch: imports, the CUDA context, the
kernels' library, the weights, the warm-up."""


def read(run):
    return run.values.get('setup_s')
