"""fitv2_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of fitv2_tpu.

It grows slice by slice beside the JAX package, which stays the reference.
This package imports torch and never JAX. Ported so far: class-conditional
FiTv2 sampling at any bucket (FiT forward with cached or online RoPE and
the RoPE interpolation modes, CFG Euler sampler and its speed modes, int8
W8A8 serving, bucketed samplers, SD-VAE decoder, checkpoint loaders, CLI)
and FID evaluation (InceptionV3, FID / sFID / IS / precision / recall,
CLI), with a hand-written CUDA kernel for each Pallas kernel of the JAX
package.
"""
