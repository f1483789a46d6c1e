"""The untraced window's share of the bf16 peak: the operations its images
required (each Euler step a forward of both CFG halves over every token,
attention over every key, then the SD-VAE decode; harness/flops.py) over
the window's wall seconds times 989 TFLOP/s, in %."""

from harness import flops


def read(run):
    v = run.values
    if v.get('kind') != 'sample':
        return None
    m, tr = run.config['model'], run.traffic
    p = m['patch_size']
    h, w = tr['image_size'][0] // (8 * p), tr['image_size'][1] // (8 * p)
    per_image = (tr['num_sampling_steps']
                 * flops.fit_forward_flops(run.config, [h * w] * 2)
                 + flops.vae_decode_flops(run.config['vae'], h * p, w * p))
    return 100.0 * per_image * v['images'] / v['window_s'] / (
        flops.PEAK_BF16_FLOPS)
