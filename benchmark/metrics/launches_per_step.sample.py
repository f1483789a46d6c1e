"""Device kernels of the traced batch (its decode included) per Euler
step, from the profiler."""


def read(run):
    if run.trace is None or run.values.get('kind') != 'sample':
        return None
    steps = run.traffic['num_sampling_steps'] * run.values['trace_batches']
    return len(run.trace.kernels()) / steps
