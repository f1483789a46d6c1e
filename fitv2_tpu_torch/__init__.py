"""fitv2_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of fitv2_tpu.

It grows slice by slice beside the JAX package, which stays the reference.
This package imports torch and never JAX. Ported so far: class-conditional
FiTv2 sampling (FiT forward, CFG Euler sampler, SD-VAE decoder, checkpoint
loaders, CLI) with hand-written CUDA kernels for the fused adaLN
LayerNorm, the q/k LayerNorm + RoPE prologue and masked attention.
"""
