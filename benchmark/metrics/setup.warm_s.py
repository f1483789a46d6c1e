"""Seconds of the fixed warm-up: the short sampler at the cell's shapes,
its decode and host copy; the kernels' library is loaded (built on the
first run in a checkout) at its first launch here."""


def read(run):
    return run.values.get('setup.warm_s')
