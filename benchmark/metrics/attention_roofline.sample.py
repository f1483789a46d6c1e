"""K4's share of its roofline in the traced batch: the calls' least time
at their shapes (CFG batch, the full token grid, every key valid;
harness/flops.py) over the kernel's device time, in %."""

from harness import flops


def read(run):
    t = run.trace
    if t is None or run.values.get('kind') != 'sample':
        return None
    idx = t.named('attention_mma_kernel', exclude=('fused',))
    if not len(idx):
        return None
    m, tr = run.config['model'], run.traffic
    n = (tr['image_size'][0] // (8 * m['patch_size'])) * (
        tr['image_size'][1] // (8 * m['patch_size']))
    bound = flops.attention_call_bound_s(
        2 * tr['batch'], m['num_heads'], n, m['hidden_size'] // m['num_heads'])
    return 100.0 * len(idx) * bound / (t.sum_ns(idx) / 1e9)
