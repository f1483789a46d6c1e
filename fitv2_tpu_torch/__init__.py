"""fitv2_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of fitv2_tpu.

It grows slice by slice beside the JAX package, which stays the reference.
This package imports torch and never JAX. Ported so far: class-conditional
FiTv2 sampling at any bucket (FiT forward with cached or online RoPE and
the RoPE interpolation modes, CFG Euler sampler and its speed modes, int8
W8A8 serving, bucketed samplers, SD-VAE decoder, checkpoint loaders, CLI),
FID evaluation (InceptionV3, FID / sFID / IS / precision / recall, CLI)
FiTv2 flow-matching training on one device (transport, AdamW + EMA,
trainer, latent shard loader, checkpoints, CLI), FiTv1 sampling and
training with improved diffusion (DDPM / DDIM over respaced ladders, the
ddpm objective) and the ODE/SDE sampler set, with a hand-written CUDA
kernel for each Pallas kernel of the JAX package; those of the training
path run inside autograd Functions with PyTorch backward passes.
"""
