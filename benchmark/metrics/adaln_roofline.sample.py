"""K1's share of its roofline in the traced batch: the calls' least time
((CFG batch, tokens, hidden) bf16 in and out, the bytes bound;
harness/flops.py) over the kernel's device time, in %."""

from harness import flops


def read(run):
    t = run.trace
    if t is None or run.values.get('kind') != 'sample':
        return None
    idx = t.named('adaln_kernel')
    if not len(idx):
        return None
    m, tr = run.config['model'], run.traffic
    n = (tr['image_size'][0] // (8 * m['patch_size'])) * (
        tr['image_size'][1] // (8 * m['patch_size']))
    bound = flops.adaln_call_bound_s(2 * tr['batch'], n, m['hidden_size'])
    return 100.0 * len(idx) * bound / (t.sum_ns(idx) / 1e9)
