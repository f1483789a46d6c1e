"""Class-conditional sampling, as FID generation runs it: the port's
``build_sampler`` (the CFG Euler loop over the FiT, then the SD-VAE decode
and the uint8 conversion) on batches of seeded labels and noise, each
batch ending in the copy of its images to the host
(``generate_fid_samples`` without the npz).

Set-up builds the FiT and the VAE on the card in the served dtype (their
initialisers run there), loads the seed's weights into them (made on the
card, benchmark/harness/weights.py), builds the sampler, and warms up
with a sampler of the same shapes and ``warmup_steps`` steps. The window runs whole
batches back to back until its seconds have passed. A traced run then
profiles one more batch. The reference recomputes two rows of one batch
of the window, drawn from the seed, one from each half of the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from harness import common, trace, traffic, weights
from harness.compare import image_gaps
from reference import fit_ref, vae_ref

# the warm-up batch's input index, apart from the window's batches
WARMUP_INPUTS = 1 << 30


def grid_tokens(run) -> Tuple[int, int]:
    p = run.config['model']['patch_size']
    h, w = run.traffic['image_size']
    return h // (8 * p), w // (8 * p)


def build(run):
    """The model, the VAE and the cell's sampler (and a warm-up sampler),
    on the run's device with the seed's weights."""
    torch = run.torch
    from fitv2_tpu_torch.models.fit import FiT
    from fitv2_tpu_torch.sample.pipeline import SamplingConfig, build_sampler
    from fitv2_tpu_torch.vae.autoencoder_kl import AutoencoderKL
    cfg, tr = run.config, run.traffic
    dtype = getattr(torch, tr['dtype'])
    torch.manual_seed(common.derive_seed(run.seed, common.WEIGHTS))
    with torch.device(run.device):
        model = FiT(**cfg['model'], dtype=dtype)
        vae = AutoencoderKL(**cfg['vae']).to(dtype)
    run.clock.mark('modules')
    model.eval()
    vae.eval()
    fit_w, vae_w = reference_weights(run, dtype)
    weights.load(model, fit_w)
    weights.load(vae, vae_w, allow_missing=('encoder.', 'quant_conv.'))
    del fit_w, vae_w
    run.clock.mark('weights')
    scfg = SamplingConfig(
        image_height=tr['image_size'][0], image_width=tr['image_size'][1],
        num_sampling_steps=tr['num_sampling_steps'],
        cfg_scale=tr['cfg_scale'], num_classes=cfg['model']['num_classes'],
        per_device_batch=tr['batch'], interpolation=tr['interpolation'],
        vae_scale=cfg['vae_scale'], dtype=dtype)
    sampler = build_sampler(model, scfg, vae=vae)
    warm = build_sampler(model, dataclasses.replace(
        scfg, num_sampling_steps=tr['warmup_steps']), vae=vae)
    return model, vae, sampler, warm


def reference_weights(run, dtype):
    """The seed's FiT and VAE weights in ``dtype`` on the run's device."""
    cfg = run.config
    return (weights.make(fit_ref.param_specs(cfg), common.derive_seed(
                run.seed, common.WEIGHTS), run.device, dtype),
            weights.make(vae_ref.param_specs(cfg['vae']), common.derive_seed(
                run.seed, common.VAE_WEIGHTS), run.device, dtype))


def compared_rows(run, batches: int) -> Tuple[int, List[int]]:
    """A batch of the window and one row from each half of it, drawn from
    the seed."""
    rng = np.random.default_rng(common.derive_seed(run.seed,
                                                   common.SAMPLE_ROWS))
    half = run.traffic['batch'] // 2
    return (int(rng.integers(batches)),
            [int(rng.integers(half)), half + int(rng.integers(half))])


def reference_images(run, index: int, rows: List[int],
                     lowp: bool = False) -> np.ndarray:
    """The plain reference's uint8 images of ``rows`` of batch ``index``,
    in float32 (float8 products with ``lowp``: the control)."""
    torch = run.torch
    cfg, tr = run.config, run.traffic
    m = cfg['model']
    n_h, n_w = grid_tokens(run)
    dtype = getattr(torch, tr['dtype'])
    fit_w, vae_w = reference_weights(run, dtype)
    fit_w = {k: v.float() for k, v in fit_w.items()}
    vae_w = {k: v.float() for k, v in vae_w.items()}
    labels, z = traffic.sample_batch(tr, cfg, run.seed, index, run.device)
    sel = torch.tensor(rows, device=run.device)
    labels, z = labels[sel], z[sel]
    R = len(rows)
    grid = fit_ref.full_grid(n_h, n_w, 2 * R, run.device)
    size = torch.tensor([[n_h, n_w]], device=run.device).expand(2 * R, 1, 2)
    with torch.no_grad():
        x = fit_ref.sample_cfg(fit_w, cfg, z, labels, grid, size,
                               tr['num_sampling_steps'], tr['cfg_scale'],
                               lowp)
        lat = fit_ref.unpatchify(x, n_h, n_w, m['patch_size'],
                                 m['in_channels'])
        img = vae_ref.decode(vae_w, cfg['vae'], lat / cfg['vae_scale'],
                             lowp)
    return vae_ref.to_uint8(img).cpu().numpy()


def run(run) -> Dict:
    torch = run.torch
    tr, cfg = run.traffic, run.config
    model, vae, sampler, warm = build(run)
    run.end_build()
    labels, z = traffic.sample_batch(tr, cfg, run.seed, WARMUP_INPUTS,
                                     run.device)
    warm(labels, z=z).cpu()
    del labels, z
    run.end_setup()
    setup_peak = run.peak_bytes()

    outputs: List[np.ndarray] = []
    t0 = run.clock.now()
    deadline = t0 + run.seconds
    while True:
        labels, z = traffic.sample_batch(tr, cfg, run.seed, len(outputs),
                                         run.device)
        outputs.append(sampler(labels, z=z).cpu().numpy())
        if run.clock.now() >= deadline:
            break
    wall = run.clock.mark('window_end') - t0
    B = tr['batch']
    run.values.update(kind='sample', images=B * len(outputs), window_s=wall,
                      batches=len(outputs))
    device_extra = {}
    if run.traced:
        decode = vae.decode

        def traced_decode(x):
            with torch.profiler.record_function('bench.vae_decode'):
                return decode(x)
        vae.decode = traced_decode
        labels, z = traffic.sample_batch(tr, cfg, run.seed, len(outputs),
                                         run.device)
        run.trace = trace.record(torch, lambda: sampler(labels, z=z).cpu())
        run.values['trace_batches'] = 1
        device_extra = dict(busy_s=run.trace.busy_ns() / 1e9,
                            window_s=run.trace.window_ns() / 1e9)
    peak = max(setup_peak, run.peak_bytes())
    run.clock.mark('traced')
    del model, vae, sampler, warm
    run.free()

    index, rows = compared_rows(run, len(outputs))
    with common.full_fp32(torch):
        ref = reference_images(run, index, rows)
    patch = 8 * cfg['model']['patch_size']
    run.compared.update(image_gaps(outputs[index][rows], ref, patch))
    return dict(attempted=B * len(outputs), failed=0,
                memory_peak_bytes=peak, device=device_extra)
