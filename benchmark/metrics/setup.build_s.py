"""Seconds from the process's start to the first warm-up step: imports,
the CUDA context, the modules built on the card, the seeded weights made
and loaded there, the sampler."""


def read(run):
    return run.values.get('setup.build_s')
