#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fitv2_tpu_torch) on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device   - a CUDA card of compute capability 9.0; its name and power
                limit as nvidia-smi reports them; TF32 off for fp32 phases.
  2. build    - nvcc builds the kernel library from fitv2_tpu_torch/kernels/
                csrc/ (sm_90a); the build seconds.
  3. kernels  - each CUDA kernel against its plain PyTorch version at the
                sampler's shapes (CFG batch 16, N 256, D 1152, H 16, Dh 72),
                bf16 and fp32, with the error against the stated tolerance
                and both median times (CUDA events).
  4. parity   - FiTv2-XL/2 (depth 36) fp32, random seeded weights with the
                zero-init leaves perturbed, batch 1, one CFG Euler step: the
                port on CUDA (kernels) against the port on the CPU (plain
                versions) on the same weights and noise; relative L2.
  5. main     - the user's path: build_sampler on XL/2 in bf16 with a random
                SD-VAE decoder, batch 8, 250 steps at 256x256, VAE, uint8,
                save_npz. Checks the npz, the latents and the exact launch
                count of every kernel; prints the denoise-only and the full
                pipeline images/s.
The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH = 8            # images per sampler call
STEPS = 250
CFG_SCALE = 1.5
N, D, H, DH = 256, 1152, 16, 72
N_VALID = 200        # padded bucket: 200 of 256 tokens valid (160x320 px)
REPS = 20

# tolerances (kernel vs its plain version on the same card)
TOL_FP32_REL = 1e-5  # max |kernel - plain| / max |plain|: fp32 sums in
                     # another order
TOL_BF16_ULPS = 2    # K1/K2 in bf16: within 2 bf16 ulps of the output's
                     # largest magnitude (one rounding of an fp32 value that
                     # differs in the last bits may flip)
TOL_BF16_ATTN = 2e-2 # attention in bf16, absolute
TOL_SLICE_REL_L2 = 1e-4  # phase 4, velocity relative L2, fp32

XL = dict(context_size=256, patch_size=2, in_channels=4, hidden_size=1152,
          depth=36, num_heads=16, mlp_ratio=4.0, class_dropout_prob=0.1,
          num_classes=1000, learn_sigma=False, use_sit=True, use_swiglu=True,
          q_norm='layernorm', k_norm='layernorm', qk_norm_weight=False,
          rel_pos_embed='rope', adaln_type='lora', adaln_lora_dim=288)


def say(*args):
    print(*args, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this smoke needs an '
                         'H100')
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f'chip_smoke: need compute capability 9.0 (Hopper),'
                         f' got {cap}')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f'[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}'
        f' cuda {torch.version.cuda}')
    say(f'[device] nvidia-smi name, power.limit: {card}')
    return card


def phase_build():
    from fitv2_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path, report = _build.build()
    secs = time.perf_counter() - t0
    _build.library()
    (path.parent / 'ptxas.txt').write_text(report)
    spills = [ln for ln in report.splitlines()
              if 'spill' in ln and not ln.strip().startswith('0 bytes')
              and ' 0 bytes spill stores, 0 bytes spill loads' not in ln]
    say(f'[build] nvcc {len(_build.sources())} sources -> {path} in '
        f'{secs:.3f} s{" (already built)" if not report else ""}; '
        f'ptxas report {path.parent / "ptxas.txt"}')
    for ln in spills:
        say(f'[build] ptxas: {ln.strip()}')
    return secs


def _time_ms(fn, reps=REPS):
    """Median device time of one call (CUDA events), after two warmups.

    Each timed call is enqueued behind a ~25 ms device sleep, so the host's
    launch overhead (Python, ctypes, allocation) is hidden and the events
    bracket device time only; the inputs stay L2-warm, as in the model."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # cycles: ~25 ms at 1.98 GHz
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bf16_ulp_err(out, ref):
    """max |out - ref| in bf16 ulps of max |ref|."""
    import math
    scale = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    return (out.float() - ref.float()).abs().max().item() / ulp


def _compare(name, dtype, out, ref, kind):
    """Check a kernel output against its plain version; returns max abs."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    worst_abs = 0.0
    for o, r in zip(outs, refs):
        if not torch.isfinite(o).all():
            raise AssertionError(f'{name} {dtype}: non-finite kernel output')
        abs_err = (o.float() - r.float()).abs().max().item()
        worst_abs = max(worst_abs, abs_err)
        if dtype == torch.float32:
            rel = abs_err / r.float().abs().max().item()
            ok, msg = rel <= TOL_FP32_REL, f'rel {rel:.3e} <= {TOL_FP32_REL}'
        elif kind == 'attention':
            ok, msg = abs_err <= TOL_BF16_ATTN, \
                f'abs {abs_err:.3e} <= {TOL_BF16_ATTN}'
        else:
            ulps = _bf16_ulp_err(o, r)
            ok, msg = ulps <= TOL_BF16_ULPS, \
                f'{ulps:.2f} bf16 ulps <= {TOL_BF16_ULPS}'
        say(f'[kernels] {name} {str(dtype)[6:]}: max abs {abs_err:.3e}, '
            f'{msg}: {"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'{name} {dtype}: {msg} violated')
    return worst_abs


def phase_kernels():
    """Each kernel against its plain version at the slice's shapes."""
    import torch
    from fitv2_tpu_torch import kernels as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b2 = 2 * BATCH
    results = {}

    def record(key, err, ms, plain_ms):
        results.setdefault(key, dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms))

    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(b2, N, D, device=dev, generator=gen).to(dtype)
        mod = (0.5 * torch.randn(b2, 6 * D, device=dev, generator=gen)
               ).to(dtype)
        shift, scale = mod.chunk(6, dim=-1)[:2]  # strided, as in a block
        out = K.fused_adaln_norm(x, shift, scale)
        ref = K.adaln_norm_reference(x, shift, scale)
        err = _compare('adaln', dtype, out, ref, 'norm')
        ms = _time_ms(lambda: K.fused_adaln_norm(x, shift, scale))
        pms = _time_ms(lambda: K.adaln_norm_reference(x, shift, scale))
        say(f'[kernels] adaln {str(dtype)[6:]} ({b2},{N},{D}): kernel '
            f'{ms * 1e3:.1f} us, plain {pms * 1e3:.1f} us')
        record('adaln', err, ms, pms)

        qkv = torch.randn(b2, N, 3, H, DH, device=dev, generator=gen
                          ).to(dtype)
        q, k, v = qkv.unbind(2)  # token stride 3C, as in a block
        ang = torch.rand(b2, N, DH, device=dev, generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)
        out = K.fused_qk_rope(q, k, cos, sin)
        ref = K.qk_norm_rope_reference(q, k, cos, sin)
        err = _compare('qk_rope', dtype, out, ref, 'norm')
        ms = _time_ms(lambda: K.fused_qk_rope(q, k, cos, sin))
        pms = _time_ms(lambda: K.qk_norm_rope_reference(q, k, cos, sin))
        say(f'[kernels] qk_rope {str(dtype)[6:]} ({b2},{N},{H},{DH}): '
            f'kernel {ms * 1e3:.1f} us, plain {pms * 1e3:.1f} us')
        record('qk_rope', err, ms, pms)

        # attention inputs: LayerNormed q/k (the bounded-logit contract)
        qn, kn = K.qk_norm_rope_reference(q, k, cos, sin)
        mask = torch.zeros(b2, N, device=dev)
        mask[:, :N_VALID] = 1.0
        for bounded in (True, False):
            plain = (K.attention_bounded_reference if bounded
                     else K.attention_reference)
            for m in (None, mask):
                label = (f'attention[{"bounded" if bounded else "online"},'
                         f'{"mask 200/256" if m is not None else "no mask"}]')
                out = K.flash_masked_attention(qn, kn, v, m, bounded)
                ref = plain(qn, kn, v, m)
                err = _compare(label, dtype, out, ref, 'attention')
                if m is not None and not torch.isfinite(out[:, N_VALID:]
                                                        ).all():
                    raise AssertionError(f'{label}: padded query rows are '
                                         'not finite')
                ms = _time_ms(lambda: K.flash_masked_attention(
                    qn, kn, v, m, bounded))
                pms = _time_ms(lambda: plain(qn, kn, v, m))
                say(f'[kernels] {label} {str(dtype)[6:]} '
                    f'({b2},{N},{H},{DH}): kernel {ms * 1e3:.1f} us, '
                    f'plain {pms * 1e3:.1f} us')
                if bounded and m is None:  # the variant the XL path runs
                    record('attention', err, ms, pms)
        torch.cuda.synchronize()
    return results


def _xl_model_fp32():
    """XL/2 on the CPU in fp32, seeded init, zero-init leaves perturbed (an
    untrained FiT outputs velocity exactly 0 and would make parity
    vacuous)."""
    import torch
    from fitv2_tpu_torch.models import FiT
    torch.manual_seed(SEED)
    model = FiT(**XL)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'adaLN_modulation.fc_out' in name or 'final_layer.linear' in name:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model.eval()


def phase_parity(model_cpu):
    """One CFG Euler step of XL in fp32: CUDA (kernels) vs CPU (plain)."""
    import torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler
    scfg = SamplingConfig(num_sampling_steps=1, cfg_scale=CFG_SCALE,
                          per_device_batch=1, dtype=torch.float32)
    z = torch.randn(1, N, 16, generator=torch.Generator().manual_seed(SEED))
    labels = torch.tensor([207])
    model_gpu = copy.deepcopy(model_cpu).to('cuda')
    # one Euler step over [0, 1]: latents = unpatchify(z) + v
    z_img = model_cpu.unpatchify(z, (32, 32))
    t0 = time.perf_counter()
    v_cpu = build_sampler(model_cpu, scfg)(labels, z=z) - z_img
    t_cpu = time.perf_counter() - t0
    v_gpu = build_sampler(model_gpu, scfg)(labels, z=z).cpu() - z_img
    if not torch.isfinite(v_gpu).all():
        raise AssertionError('parity: non-finite velocity on CUDA')
    norm = v_cpu.norm().item()
    if norm == 0.0:
        raise AssertionError('parity: zero velocity (vacuous comparison)')
    rel = (v_gpu - v_cpu).norm().item() / norm
    say(f'[parity] XL fp32 depth 36, batch 1 (CFG 2), 1 Euler step: '
        f'|v| {norm:.4e}, relative L2 CUDA vs CPU {rel:.3e} <= '
        f'{TOL_SLICE_REL_L2}: {"ok" if rel <= TOL_SLICE_REL_L2 else "FAIL"}'
        f' (CPU step {t_cpu:.1f} s)')
    if not rel <= TOL_SLICE_REL_L2:
        raise AssertionError(f'parity: relative L2 {rel} > {TOL_SLICE_REL_L2}')
    return model_gpu, rel


def phase_main(model_gpu, card):
    """The main path in bf16: sampler -> VAE -> uint8 -> npz, counted."""
    import numpy as np
    import torch
    from fitv2_tpu_torch import kernels as K
    from fitv2_tpu_torch.sample import (
        SamplingConfig, build_sampler, save_npz)
    from fitv2_tpu_torch.vae import AutoencoderKL

    model = model_gpu.to(torch.bfloat16)
    torch.manual_seed(SEED + 2)
    vae = AutoencoderKL().to(device='cuda', dtype=torch.bfloat16).eval()
    scfg = SamplingConfig(num_sampling_steps=STEPS, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    labels = torch.arange(BATCH) * 111 % 1000
    z = torch.randn(BATCH, N, 16, generator=torch.Generator().manual_seed(
        SEED + 3))

    # warm-up: two steps through every kernel, cuBLAS and cuDNN
    warm = SamplingConfig(num_sampling_steps=2, cfg_scale=CFG_SCALE,
                          per_device_batch=BATCH, dtype=torch.bfloat16)
    build_sampler(model, warm, vae)(labels, z=z)
    torch.cuda.synchronize()

    denoise = build_sampler(model, scfg)
    t0 = time.perf_counter()
    latents = denoise(labels, z=z)
    torch.cuda.synchronize()
    t_denoise = time.perf_counter() - t0
    z_img = model.unpatchify(z.cuda(), (32, 32)).float()
    moved = (latents - z_img).norm().item() / z_img.norm().item()
    if not torch.isfinite(latents).all() or not moved > 1e-3:
        raise AssertionError(f'main: latents not finite or not moved '
                             f'(relative change {moved})')

    sample = build_sampler(model, scfg, vae)
    for w in K.KERNEL_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    images = sample(labels, z=z)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'samples.npz')
        save_npz(path, images.cpu().numpy())
        t_full = time.perf_counter() - t0
        arr = np.load(path)['arr_0']
    counts = {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}
    if arr.shape != (BATCH, 256, 256, 3) or arr.dtype != np.uint8:
        raise AssertionError(f'main: npz holds {arr.shape} {arr.dtype}')
    depth = model.depth
    want = {'fused_adaln_norm': STEPS * (2 * depth + 1),
            'fused_qk_rope': STEPS * depth,
            'flash_masked_attention': STEPS * depth}
    if counts != want:
        raise AssertionError(f'main: launch counts {counts} != {want}')
    say(f'[main] latents finite, relative change from noise {moved:.3f}; '
        f'npz {arr.shape} {arr.dtype}, pixel mean {arr.mean():.2f}')
    say(f'[main] launches {counts} == expected')
    say(f'[main] XL/2 bf16 256x256 batch {BATCH}, {STEPS} steps, CFG '
        f'{CFG_SCALE}: denoise {t_denoise:.3f} s = '
        f'{BATCH / t_denoise:.4f} images/s; full pipeline (denoise + VAE + '
        f'uint8 + npz) {t_full:.3f} s = {BATCH / t_full:.4f} images/s '
        f'[{card}]')
    return counts


def main():
    card = phase_device()
    import torch
    phase_build()
    results = phase_kernels()
    model_cpu = _xl_model_fp32()
    model_gpu, _ = phase_parity(model_cpu)
    del model_cpu
    counts = phase_main(model_gpu, card)
    src = 'fitv2_tpu_torch/kernels/csrc/'
    meta = [
        ('adaln', 'fused_adaln_norm', src + 'adaln.cu',
         'fitv2_tpu/ops/fused_adaln.py:28'),
        ('qk_rope', 'fused_qk_rope', src + 'qk_rope.cu',
         'fitv2_tpu/ops/fused_qk_rope.py:29'),
        ('attention', 'flash_masked_attention', src + 'attention.cu',
         'fitv2_tpu/ops/attention_core.py:51 (bounded, K4) and '
         'fitv2_tpu/ops/flash_attention.py:44 (online, K3)'),
    ]
    kernels = [dict(name=name, route='cuda', source=source, replaces=rep,
                    launches=counts[wrapper], **results[name])
               for name, wrapper, source, rep in meta]
    say(card)  # nvidia-smi's name, power.limit line
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
