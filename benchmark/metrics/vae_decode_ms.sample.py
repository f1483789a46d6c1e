"""Device busy ms per batch of the work launched inside the SD-VAE decode
(the harness's range around the sampler's call of ``vae.decode``)."""


def read(run):
    t = run.trace
    if t is None or run.values.get('kind') != 'sample':
        return None
    idx = t.launched_within(t.ranges('bench.vae_decode'))
    if not len(idx):
        return None
    return t.busy_ns(idx) / 1e6 / run.values['trace_batches']
