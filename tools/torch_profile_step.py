#!/usr/bin/env python3
"""Where the time of one sampler step, or one train step, of the PyTorch
port goes, on one H100.

Run from the repository root on a machine with the card:

    python3 tools/torch_profile_step.py
        [--path bf16|int8|fused|hr|fitv1|train|train_hr|lwd_xl|
                lwd_multiscale|bfm_xl] [--remat dots|dots_offload|full]
        [--steps N] [--tree DIR]

Builds chip_smoke.py's FiTv2-XL/2 (random weights from its seed, the
zero-init leaves perturbed) in bf16 on the card (``--path int8``: the int8
W8A8 model on the same weights, calibrated by the sampler; ``--path
fused``: ``attn_impl='fused'`` on chip_smoke.py's padded 160x320 bucket,
200 of 256 tokens valid; ``--path hr``: the same weights as FiTv2-HR-XL/2,
online decoupled NTK RoPE, at 512x512 (1024 tokens) and chip_smoke.py's HR
batch; ``--path fitv1``: chip_smoke.py's FiTv1-XL/2 of configs/fit_xl.yaml
(depth 28, learn_sigma, no q/k norm: K2 RoPE-only, K3) sampling with the
DDPM loop over ``--steps`` respaced steps), at chip_smoke.py's batch and CFG
scale (256x256 unless fused or hr), warms the sampler up, then measures:

- wall ms per step: three unprofiled sampler calls of ``--steps`` steps
  (default STEPS), each ended by ``torch.cuda.synchronize()`` (the rate,
  images/s, comes from these);
- from ``torch.profiler`` over one more such call, recording the
  device's activity only: the device busy ms per step (the union of the
  kernels' and copies' intervals), the wall ms per step of that profiled
  window itself and the idle share, 1 - busy / that wall (both from one
  window, so it is never below 0), kernel launches per step and the
  summed device ms and count per step of each group (the port's kernels
  by name, cuBLAS, copies, the rest).

``--path train`` profiles one train step of the same XL/2 weights
(fp32 masters on the card, a bf16 copy computing, bf16 mu, fp32 EMA) at
configs/fitv2_xl.yaml's per-host batch of 32 on one batch of synthetic
shards padded to 256 tokens (the loader is left out): the wall ms per step
as above; the full step's device busy ms, launches and groups; the
training forward alone (the flow loss with autograd recording) and the
update alone (AdamW and the EMA over the masters); the backward is what is
left of the step.

``--path train_hr`` profiles one train step of the same weights as
FiTv2-HR-XL/2 (configs/fitv2_hr_xl.yaml: online decoupled NTK RoPE, per-
block remat under ``--remat``, default its 'dots') at its per-host batch of
8 on one batch of synthetic shards padded to 1024 tokens: the wall ms per
step; from one profiled window of ``--steps`` steps with no sync inside a
step, the device busy ms, the window's wall and the idle share, as above;
the host ms a step spent inside selective checkpointing's dispatch modes
(the forward's and the recompute's, torch's or dots_offload's; the host
side of the ops they run included, and any wait for room in the launch
queue) and the ops through them, over ``--steps`` more steps; then one
profiled step whose device busy time is split by the phase that launched
the work: the forward, the recompute (each block's forward rerun inside
the backward, each bracketed by a synchronisation), the rest of the
backward, the update (the masters, the norm and clip, AdamW, the EMA) and
the rest (the draws, the master -> bf16 copy, the loss), the copies to
and from the host apart (dots_offload's side streams: each direction's
busy ms, and the ms of copies that no kernel overlaps).

``--path lwd_xl``, ``lwd_multiscale`` and ``bfm_xl`` profile chip_smoke.py's
phase-13 LwD paths (the seeded models of configs/fitv2_xl_lwd.yaml and
configs/bfm_xl.yaml, perturbed, in bf16, at its batch): FiTLwD-XL's
``sample_cfg`` (CFG 1.4), its ``sample_multiscale`` and BFM-XL's
``sample_maruyama_cfg`` with self-guidance in chip_smoke.py's guidance
window; ``--steps`` is then the sub-steps a segment (default
chip_smoke.py's), and every number is per velocity eval (the whole call
divided by its K x steps evals): wall ms from three unprofiled calls,
device busy ms, the profiled wall, the idle share, launches and groups.

``--tree`` imports ``fitv2_tpu_torch`` from another checkout (for example
the parent commit unpacked by ``git archive``), so that two versions can be
compared on one card in one call; the model's definition stays this
checkout's chip_smoke.py. Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10

# kernel name fragment -> group; the first match wins
GROUPS = (('fused_attention_', 'fused_attention (K5)'),
          ('attention_', 'attention (K3/K4)'),
          ('adaln_kernel', 'adaln (K1)'),
          ('qk_rope_kernel', 'qk_rope (K2)'),
          ('int8_gemm_wgmma', 'int8_gemm_bias (K6)'),
          ('int8_gemm_swiglu', 'int8_gemm_swiglu_quant (K7)'),
          ('nvjet', 'cuBLAS'), ('gemm', 'cuBLAS'), ('cutlass', 'cuBLAS'),
          ('sm90_xmma', 'cuBLAS'),
          ('multi_tensor_apply', 'foreach (AdamW, EMA, clip, copies)'))


def group_of(name: str) -> str:
    return next((g for frag, g in GROUPS if frag in name),
                'elementwise and other')


def profile(fn, steps):
    """From torch.profiler over `steps` calls of fn, per step: the device
    busy ms (the union of the kernels' and copies' intervals, so work that
    overlaps counts once), the wall ms of the profiled window itself (from
    before the first call to after a closing sync), launches, and
    [summed ms, count] of each kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    # the device's activity only: recording every host op too would slow a
    # host-bound step and so inflate the window's idle share
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    groups: dict[str, list[float]] = {}
    launches = 0
    spans = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        copy = 'Memcpy' in evt.name or 'Memset' in evt.name
        launches += not copy
        ms_count = groups.setdefault(
            'memcpy and memset' if copy else group_of(evt.name), [0.0, 0])
        ms_count[0] += evt.time_range.elapsed_us() / 1e3
        ms_count[1] += 1
        spans.append((evt.time_range.start, evt.time_range.end))
    if not spans:
        raise RuntimeError('torch.profiler recorded no device activity')
    # intervals that overlap (another stream, or records that overlap)
    # count once: a sum of durations would count them twice
    busy_us = sum(stop - start for start, stop in union(spans))
    return busy_us / 1e3 / steps, window / steps, launches / steps, {
        g: [ms / steps, n / steps] for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])}


def union(spans):
    """The sorted, merged intervals of `spans`."""
    merged = []
    for start, stop in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return merged


def uncovered(start, stop, merged):
    """The length of [start, stop) that no interval of `merged` covers."""
    covered = sum(max(0.0, min(stop, b) - max(start, a)) for a, b in merged)
    return stop - start - covered


def wall_ms(fn, steps):
    """Three unprofiled runs of `steps` calls, each ended by a sync."""
    import torch
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    return walls


def sac_dispatch_ms(fn, steps):
    """Host ms and ops a call spends inside selective checkpointing's
    dispatch modes (torch.utils.checkpoint's caching mode in the forward,
    its cached mode in the recompute), over `steps` calls of fn, each
    mode's __torch_dispatch__ wrapped in a timer (the time includes the
    host side of the ops that the mode runs)."""
    import torch
    from torch.utils import checkpoint
    from fitv2_tpu_torch.models import remat
    spent = [0.0, 0]
    patched = []
    for cls in (checkpoint._CachingTorchDispatchMode,
                checkpoint._CachedTorchDispatchMode, remat._SaveToHost,
                remat._LoadFromHost):
        orig = cls.__dict__['__torch_dispatch__']

        def timed(self, func, types, args=(), kwargs=None, _orig=orig):
            t0 = time.perf_counter()
            try:
                return _orig(self, func, types, args, kwargs)
            finally:
                spent[0] += time.perf_counter() - t0
                spent[1] += 1
        patched.append((cls, orig))
        cls.__torch_dispatch__ = timed
    try:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    finally:
        for cls, orig in patched:
            cls.__torch_dispatch__ = orig
    return spent[0] * 1e3 / steps, spent[1] / steps


def train_profile(chip_smoke, steps):
    """The --path train measurements (see the module docstring)."""
    import copy
    import tempfile
    import torch
    from fitv2_tpu_torch.data import INLatentLoader, make_synthetic_latent_shards
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.train import (
        OptimizerConfig, create_train_state, flow_loss, get_scheduler,
        make_train_step, update_ema)
    from fitv2_tpu_torch.train.trainer import step_generator
    batch_size, n = chip_smoke.TRAIN_BATCH, chip_smoke.N
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_latent_shards(root, n=batch_size, target_len=n,
                                     seed=chip_smoke.SEED)
        loader = INLatentLoader(root, n, batch_size=batch_size, num_workers=4)
        batch_np = next(iter(loader.train_dataloader(batch_size, 1, 0)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    master = chip_smoke._xl_model_fp32().cuda()
    model = copy.deepcopy(master).to(torch.bfloat16)
    lr = 1e-4 * batch_size / 256
    state = create_train_state(master, OptimizerConfig(
        learning_rate=lr, mu_dtype=torch.bfloat16,
        lr_schedule=get_scheduler('constant_with_warmup', lr,
                                  num_warmup_steps=50000)))
    transport = create_transport('Linear', 'velocity', snr_type='lognorm')
    train_step = make_train_step(model, transport)

    def step():
        train_step(state, batch, step_generator(0, state.step))

    def forward():
        loss, _ = flow_loss(model, transport, batch,
                            step_generator(0, state.step))
        del loss  # the graph is dropped unused

    def update():
        state.optimizer.step()
        update_ema(state.ema_params, state.params)

    for _ in range(2):
        step()  # warm-up: cuBLAS plans, the kernel library, the allocator
    torch.cuda.synchronize()
    walls = wall_ms(step, steps)
    busy, window, launches, groups = profile(step, steps)
    fwd_busy, _, fwd_launches, fwd_groups = profile(forward, steps)
    for p in state.params.values():  # grads of the right shape for update()
        p.grad = torch.zeros_like(p)
    upd_busy, _, upd_launches, _ = profile(update, steps)
    return {
        'batch': batch_size, 'tokens': n,
        'valid_tokens': float(batch_np['mask'].sum()),
        'wall_ms_per_step': walls, 'device_busy_ms_per_step': busy,
        'profiled_wall_ms_per_step': window, 'idle_share': 1 - busy / window,
        'images_per_s': [batch_size / w * 1e3 for w in walls],
        'launches_per_step': launches, 'groups_ms_per_step': groups,
        'forward': {'device_busy_ms': fwd_busy, 'launches': fwd_launches,
                    'groups_ms': fwd_groups},
        'update': {'device_busy_ms': upd_busy, 'launches': upd_launches},
        'backward_and_rest_busy_ms': busy - fwd_busy - upd_busy,
        'peak_memory_bytes': torch.cuda.max_memory_allocated(),
    }


def hr_train_profile(chip_smoke, steps, remat):
    """The --path train_hr measurements (see the module docstring)."""
    import copy
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    from fitv2_tpu_torch.data import INLatentLoader, make_synthetic_latent_shards
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    from fitv2_tpu_torch.train.trainer import step_generator
    batch_size, n = 8, chip_smoke.HR_N
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_latent_shards(root, n=batch_size, target_len=n,
                                     seed=chip_smoke.SEED)
        loader = INLatentLoader(root, n, batch_size=batch_size, num_workers=4)
        batch_np = next(iter(loader.train_dataloader(batch_size, 1, 0)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    master = FiT(**chip_smoke.HR_XL, use_checkpoint=True, remat_policy=remat)
    master.load_state_dict(chip_smoke._xl_model_fp32().state_dict())
    master = master.cuda()
    model = copy.deepcopy(master).to(torch.bfloat16)
    state = create_train_state(master, OptimizerConfig(
        learning_rate=1e-4, mu_dtype=torch.bfloat16))
    train_step = make_train_step(model, create_transport(
        'Linear', 'velocity', snr_type='lognorm'))

    def step():
        train_step(state, batch, step_generator(0, state.step))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = wall_ms(step, steps)
    peak = torch.cuda.max_memory_allocated()
    step_busy, step_window, step_launches, _ = profile(step, steps)
    sac_ms, sac_ops = sac_dispatch_ms(step, steps)

    backward = torch.Tensor.backward
    in_backward = [False]

    def bracket(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            with record_function(name):
                out = fn(*a, **k)
                torch.cuda.synchronize()
            return out
        return run

    def bwd(self, *a, **k):
        in_backward[0] = True
        try:
            bracket('split:backward', backward)(self, *a, **k)
        finally:
            in_backward[0] = False

    def block_fn(block):
        forward = block.forward

        def run(*a, **k):
            if in_backward[0]:
                return bracket('split:recompute', forward)(*a, **k)
            return forward(*a, **k)
        return run

    model.forward = bracket('split:forward', model.forward)
    for block in model.blocks:
        block.forward = block_fn(block)
    torch.Tensor.backward = bwd
    try:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function('split:step'):
                step()
                torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
    finally:
        torch.Tensor.backward = backward
        del model.forward
        for block in model.blocks:
            del block.forward
    ranges: dict[str, list] = {}
    spans, copies = [], {'d2h': [], 'h2d': []}
    for evt in prof.events():
        if evt.name.startswith('split:'):
            if evt.device_type == torch.autograd.DeviceType.CPU:
                ranges.setdefault(evt.name[len('split:'):], []).append(
                    (evt.time_range.start, evt.time_range.end))
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            span = (evt.time_range.start, evt.time_range.end)
            if 'Memcpy DtoH' in evt.name:
                copies['d2h'].append(span)
            elif 'Memcpy HtoD' in evt.name:
                copies['h2d'].append(span)
            else:
                spans.append(span)
    want_recompute = len(model.blocks) if remat else 0
    if (not spans or len(ranges.get('recompute', [])) != want_recompute
            or any(len(ranges.get(k, [])) != 1
                   for k in ('forward', 'backward', 'step'))):
        raise RuntimeError(f'busy split: ranges '
                           f'{ {k: len(v) for k, v in ranges.items()} }')

    def part(start):
        for name in ('recompute', 'forward', 'backward'):
            if any(a <= start < b for a, b in ranges.get(name, [])):
                return name
        if ranges['backward'][0][1] <= start < ranges['step'][0][1]:
            return 'update'
        return 'rest'

    busy: dict[str, float] = {}
    ends: dict[str, float] = {}
    for start, stop in sorted(spans):
        p = part(start)
        end = ends.get(p, float('-inf'))
        if stop > end:
            busy[p] = busy.get(p, 0.0) + (stop - max(start, end)) / 1e3
            ends[p] = stop
    split = {p: busy.get(p, 0.0) for p in ('forward', 'recompute',
                                           'backward', 'update', 'rest')}
    kernels = union(spans)
    copy_split = {}
    for way, way_spans in copies.items():
        merged = union(way_spans)
        copy_split[f'{way}_busy_ms'] = sum(b - a for a, b in merged) / 1e3
        copy_split[f'{way}_alone_ms'] = sum(
            uncovered(a, b, kernels) for a, b in merged) / 1e3
    return {
        'batch': batch_size, 'tokens': n, 'remat': remat,
        'valid_tokens': float(batch_np['mask'].sum()),
        'wall_ms_per_step': walls,
        'images_per_s': [batch_size / w * 1e3 for w in walls],
        'peak_memory_bytes': peak,
        'device_busy_ms_per_step': step_busy,
        'profiled_wall_ms_per_step': step_window,
        'idle_share': 1.0 - step_busy / step_window,
        'launches_per_step': step_launches,
        'sac_dispatch_host_ms_per_step': sac_ms,
        'sac_dispatch_ops_per_step': sac_ops,
        'split_busy_ms': split, 'split_device_busy_ms': sum(split.values()),
        'split_copies': copy_split,
        'split_profiled_wall_ms': window,
        'split_launches': len(spans),
    }


LWD_PATHS = ('lwd_xl', 'lwd_multiscale', 'bfm_xl')


def lwd_profile(chip_smoke, path, steps):
    """The --path lwd_xl / lwd_multiscale / bfm_xl measurements (see the
    module docstring), per velocity eval."""
    import torch
    model = chip_smoke._lwd_model_fp32(
        chip_smoke.BFM_XL_CONFIG if path == 'bfm_xl'
        else chip_smoke.LWD_CONFIG).to('cuda', torch.bfloat16)
    sub = steps or chip_smoke._lwd_sub_steps(path)
    batch = chip_smoke.BATCH
    z, y = (a.cuda() for a in chip_smoke._lwd_inputs(path))

    def call():
        chip_smoke._lwd_call(path, model, z, y, sub)
    evals = model.number_of_perflow * sub
    call()  # warm-up
    torch.cuda.synchronize()
    walls = wall_ms(call, 1)
    busy, window, launches, groups = profile(call, 1)
    return {
        'batch': batch, 'sub_steps_per_flow': sub, 'velocity_evals': evals,
        'images_per_s': [batch / w * 1e3 for w in walls],
        'wall_ms_per_eval': [w / evals for w in walls],
        'device_busy_ms_per_eval': busy / evals,
        'profiled_wall_ms_per_eval': window / evals,
        'idle_share': 1 - busy / window,
        'launches_per_eval': launches / evals,
        'groups_ms_per_eval': {g: [ms / evals, k / evals]
                               for g, (ms, k) in groups.items()},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', choices=('bf16', 'int8', 'fused', 'hr',
                                       'fitv1', 'train', 'train_hr')
                    + LWD_PATHS, default='bf16')
    ap.add_argument('--remat', choices=('dots', 'dots_offload', 'full'),
                    default='dots',
                    help='--path train_hr: the remat policy (configs/'
                         'fitv2_hr_xl.yaml: dots)')
    ap.add_argument('--steps', type=int, default=None,
                    help=f'sampler steps a call (default {STEPS}; the train '
                         'path: steps timed; the LwD paths: sub-steps a '
                         'segment)')
    ap.add_argument('--tree', default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # imports no fitv2_tpu_torch at module level
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    card = chip_smoke.phase_device()
    import fitv2_tpu_torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler

    head = {'path': args.path, 'tree': os.path.abspath(args.tree),
            'package': os.path.dirname(fitv2_tpu_torch.__file__),
            'card': card}
    if args.path in LWD_PATHS:
        print(json.dumps({**head, **lwd_profile(chip_smoke, args.path,
                                                args.steps)}), flush=True)
        return
    args.steps = args.steps or STEPS
    if args.path == 'train':
        print(json.dumps({**head, 'steps': args.steps,
                          **train_profile(chip_smoke, args.steps)}),
              flush=True)
        return
    if args.path == 'train_hr':
        print(json.dumps({**head, 'steps': args.steps, **hr_train_profile(
            chip_smoke, args.steps, args.remat)}), flush=True)
        return
    extra = {}
    if args.path == 'hr':
        model = chip_smoke.hr_model_bf16()
        hw, batch, n_ctx = (512, 512), chip_smoke.HR_BATCH, chip_smoke.HR_N
        extra = {'interpolation': 'keep'}
    elif args.path == 'fitv1':
        model = chip_smoke._v1_model_fp32().to('cuda', torch.bfloat16)
        hw, batch, n_ctx = (256, 256), chip_smoke.BATCH, 256
        extra = {'sampler_mode': 'ddpm',
                 'diffusion_config': chip_smoke._v1_diffusion_config()}
    else:
        options = {'bf16': {}, 'int8': dict(gemm_precision='int8'),
                   'fused': dict(attn_impl='fused')}[args.path]
        model = chip_smoke.xl_model_bf16(**options)
        hw = chip_smoke.PADDED_HW if args.path == 'fused' else (256, 256)
        batch, n_ctx = chip_smoke.BATCH, 256
    labels = torch.arange(batch) * 111 % 1000
    z = torch.randn(batch, n_ctx, 16, generator=torch.Generator().manual_seed(
        chip_smoke.SEED + 3))
    scfg = SamplingConfig(image_height=hw[0], image_width=hw[1],
                          num_sampling_steps=args.steps,
                          cfg_scale=chip_smoke.CFG_SCALE,
                          per_device_batch=batch, dtype=torch.bfloat16,
                          **extra)
    sample = build_sampler(model, scfg)  # int8: calibrates here

    def call():  # fitv1's DDPM draws its per-step noise from the generator
        sample(labels, z=z, generator=torch.Generator().manual_seed(1))
    call()  # warm-up
    torch.cuda.synchronize()
    steps = args.steps
    walls = [w / steps for w in wall_ms(call, 1)]
    busy, window, launches, groups = profile(call, 1)
    busy, window, launches = busy / steps, window / steps, launches / steps
    print(json.dumps({
        **head, 'steps': steps,
        'wall_ms_per_step': walls,
        'device_busy_ms_per_step': busy,
        'profiled_wall_ms_per_step': window,
        'idle_share': 1 - busy / window,
        'launches_per_step': launches,
        'groups_ms_per_step': {g: [ms / steps, k / steps]
                               for g, (ms, k) in groups.items()},
    }), flush=True)


if __name__ == '__main__':
    main()
