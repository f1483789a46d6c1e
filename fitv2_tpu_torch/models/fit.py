"""FiT / FiTv2: flexible diffusion transformer over padded token sequences.

Counterpart of fitv2_tpu/models/fit.py, for sampling and training. The
depth-D block stack is a plain Python loop over ``blocks``; RoPE cos/sin
are computed once per forward from the token grid (or passed in
precomputed by a caller that reuses one grid, as the sampler does). All
shapes are static per bucket: callers pad to the model's context length.
Tokens are (B, N, C).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from fitv2_tpu_torch.models import rope as rope_lib
from fitv2_tpu_torch.models.modules import (
    AdaLNModulation, FiTBlock, FinalLayer, LabelEmbedder, PatchEmbedder,
    TimestepEmbedder)
from fitv2_tpu_torch.models.remat import REMAT_SAVED_OPS, OffloadSession
from fitv2_tpu_torch.parallel.comms import keep_grad
from fitv2_tpu_torch.parallel.mesh import sequence_sharding

Tensor = torch.Tensor
RopeTables = Tuple[Tensor, Tensor]

def embed_pre_trunk(model: 'FiT', x: Tensor, t: Tensor, y: Tensor,
                    grid: Tensor, size: Optional[Tensor] = None,
                    rope: Optional[RopeTables] = None, train: bool = False,
                    force_drop_ids: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Time shift, patch/time/label embeddings (labels dropped to the null
    class in training, see ``LabelEmbedder``), RoPE tables and the global
    adaLN term. Returns (x, c, freqs_cos, freqs_sin, global_adaln)."""
    ts = model.time_shifting
    t = torch.clamp(ts * t / (1.0 + (ts - 1.0) * t), max=1.0)
    t = t.to(model.dtype)
    x = model.x_embedder(x.to(model.dtype))
    c = model.t_embedder(t) + model.y_embedder(
        y, train, force_drop_ids, generator)  # (B, D)
    freqs_cos, freqs_sin = (rope if rope is not None
                            else model.rope(grid, size))
    global_adaln = (model.global_adaLN_modulation(c)
                    if model.adaln_type == 'lora' else 0.0)
    return x, c, freqs_cos, freqs_sin, global_adaln


def finalize_post_trunk(model: 'FiT', x: Tensor, c: Tensor,
                        mask: Optional[Tensor]) -> Tensor:
    """Final layer, then padded tokens zeroed."""
    x = model.final_layer(x, c)
    if mask is not None:
        x = x * mask.to(x.dtype)[..., None]
    return x


class FiT(nn.Module):
    """Flexible Diffusion Transformer; keyword arguments as the JAX FiT's.

    ``dtype`` is the compute dtype, which the parameters are stored in
    (float32, or bfloat16 for serving; a later ``.to(dtype)`` changes it).
    ``gemm_precision='int8'`` makes the blocks' qkv, proj and MLP GEMMs
    int8 W8A8 (``Int8Linear``); adaLN, the embedders and the final layer
    stay in ``dtype``. The sampler calibrates and prequantizes them.
    ``use_checkpoint`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``) where autograd records the forward:
    everything with ``remat_policy='full'``, all but the matrix products
    with 'dots' and 'dots_all' (``REMAT_SAVED_OPS``, selective
    checkpointing); 'dots_offload' saves what 'dots' saves in pinned host
    memory until the backward (models/remat.py). Knobs of the JAX model
    that do not change a forward pass (``scan_blocks``, ``use_sit``) are
    accepted for config compatibility;
    ``scan_blocks`` is kept: it sets the layout of JAX's parameter tree
    (each block parameter stacked over depth, ``ckpt.jax_leaves``).
    ``save_attention`` keeps each block's softmax probabilities
    (eval/attention_viz.py); ``add_rel_pe_to_v`` rotates v too, and makes
    ``rope_layout`` 'interleaved' whatever was asked, as JAX's model does
    for its attention and its RoPE tables.

    ``sequence_mesh`` (a ``parallel.Mesh``, or set later as an attribute)
    splits the tokens over its sequence axis after the embedders: the
    blocks run on this rank's N/S tokens (the tables cut alike, the mask
    whole for the attention's keys), the final layer too, and the output
    is gathered whole. Where the split does not apply (N or the heads not
    divisible by S) every rank runs the whole sequence, and only sequence
    rank 0 keeps the output's gradient, so that the step's sum over the
    axis counts it once. ``pipeline`` (set by
    ``parallel.make_pipelined_forward``) runs the blocks as a GPipe stage.
    """

    def __init__(self, context_size: int = 256, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 1000,
                 learn_sigma: bool = True, use_sit: bool = False,
                 use_checkpoint: bool = False, use_swiglu: bool = False,
                 use_swiglu_large: bool = False,
                 rel_pos_embed: Optional[str] = 'rope',
                 norm_type: str = 'layernorm', q_norm: Optional[str] = None,
                 k_norm: Optional[str] = None, qk_norm_weight: bool = False,
                 qkv_bias: bool = True, ffn_bias: bool = True,
                 adaln_bias: bool = True, adaln_type: str = 'normal',
                 adaln_lora_dim: Optional[int] = None,
                 rope_theta: float = 10000.0, custom_freqs: str = 'normal',
                 max_pe_len_h: Optional[int] = None,
                 max_pe_len_w: Optional[int] = None, decouple: bool = False,
                 ori_max_pe_len: Optional[int] = None,
                 online_rope: bool = False, add_rel_pe_to_v: bool = False,
                 time_shifting: float = 1.0, max_cached_len: int = 512,
                 dtype: torch.dtype = torch.float32, attn_impl: str = 'auto',
                 scan_blocks: bool = True, save_attention: bool = False,
                 remat_policy: str = 'full', rope_layout: str = 'split',
                 gemm_precision: str = 'bf16', sequence_mesh=None):
        super().__init__()
        if gemm_precision not in ('bf16', 'int8'):
            raise ValueError(f'gemm_precision={gemm_precision!r}: use '
                             "'bf16' or 'int8'")
        if rope_layout not in ('split', 'interleaved'):
            raise ValueError(f'rope_layout={rope_layout!r}')
        if add_rel_pe_to_v:  # v's basis: the attention and tables rotate
            rope_layout = 'interleaved'  # interleaved, as JAX's do
        self.context_size = context_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.learn_sigma = learn_sigma
        self.adaln_type = adaln_type
        self.rel_pos_embed = rel_pos_embed
        self.time_shifting = time_shifting
        self.rope_layout = rope_layout
        self.gemm_precision = gemm_precision
        self.use_checkpoint = use_checkpoint
        self.remat_policy = remat_policy
        self.scan_blocks = scan_blocks
        self.sequence_mesh = sequence_mesh
        self.pipeline = None
        self.rope_config = rope_lib.RopeConfig(
            head_dim=hidden_size // num_heads, mode=custom_freqs,
            theta=rope_theta, max_cached_len=max_cached_len,
            max_pe_len_h=max_pe_len_h, max_pe_len_w=max_pe_len_w,
            decouple=decouple, ori_max_pe_len=ori_max_pe_len,
            online=online_rope, layout=rope_layout)
        self._rope_cache: Dict[Tuple[rope_lib.RopeConfig, torch.device],
                               Dict[str, Tensor]] = {}

        D = hidden_size
        self.x_embedder = PatchEmbedder(patch_size ** 2 * in_channels, D)
        self.t_embedder = TimestepEmbedder(D)
        self.y_embedder = LabelEmbedder(num_classes, D, class_dropout_prob)
        if adaln_type == 'lora':
            self.global_adaLN_modulation = AdaLNModulation(
                D, 6, adaln_type='normal', bias=adaln_bias)
        self.blocks = nn.ModuleList([FiTBlock(
            D, num_heads, mlp_ratio=mlp_ratio, swiglu=use_swiglu,
            swiglu_large=use_swiglu_large, norm_layer=norm_type,
            q_norm=q_norm, k_norm=k_norm, qk_norm_weight=qk_norm_weight,
            qkv_bias=qkv_bias, ffn_bias=ffn_bias, adaln_bias=adaln_bias,
            adaln_type=adaln_type, adaln_lora_dim=adaln_lora_dim,
            use_rope=rel_pos_embed is not None,
            add_rel_pe_to_v=add_rel_pe_to_v, attn_impl=attn_impl,
            save_attention=save_attention, rope_layout=rope_layout,
            quantized=gemm_precision == 'int8')
            for _ in range(depth)])
        self.final_layer = FinalLayer(D, patch_size, self.out_channels,
                                      norm_layer=norm_type,
                                      adaln_bias=adaln_bias,
                                      adaln_type=adaln_type)
        self._init_weights()
        self.to(dtype)

    def _init_weights(self) -> None:
        """The JAX package's initialisers: xavier-uniform Linear weights with
        zero bias, N(0, 0.02) timestep MLP, zero adaLN output layers and a
        zero final projection (so an untrained FiT outputs exactly 0)."""
        zero_init = {id(m.fc2 if m.adaln_type == 'swiglu' else m.fc_out)
                     for m in self.modules() if isinstance(m, AdaLNModulation)}
        zero_init.add(id(self.final_layer.linear))
        normal_init = {id(self.t_embedder.mlp_0), id(self.t_embedder.mlp_2)}
        for m in self.modules():
            if not isinstance(m, nn.Linear):
                continue
            if id(m) in zero_init:
                nn.init.zeros_(m.weight)
            elif id(m) in normal_init:
                nn.init.normal_(m.weight, std=0.02)
            else:
                nn.init.xavier_uniform_(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype: the dtype the parameters are stored in."""
        return self.x_embedder.proj.weight.dtype

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def rope(self, grid: Tensor, size: Optional[Tensor] = None,
             config: Optional[rope_lib.RopeConfig] = None
             ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """float32 cos/sin (B, N, Dh) for a (B, 2, N) grid, on grid's device.

        ``config`` replaces the model's ``rope_config`` (the sampler's
        interpolation modes; the counterpart of JAX's ``model.clone``). An
        online config recomputes the frequencies from each sample's (h, w)
        in ``size`` (B, 1, 2); a cached one gathers from tables built once
        per config and device."""
        if self.rel_pos_embed is None:
            return None, None
        cfg = config if config is not None else self.rope_config
        if cfg.online:
            if size is None:
                raise ValueError('online RoPE needs the per-sample size')
            return rope_lib.online_rope_from_grid(cfg, grid, size)
        key = (cfg, grid.device)
        if key not in self._rope_cache:
            self._rope_cache[key] = {
                k: v.to(grid.device)
                for k, v in rope_lib.build_rope_cache(cfg).items()}
        return rope_lib.rope_from_grid(self._rope_cache[key], grid,
                                       cfg.layout)

    def _remat(self):
        """None where blocks keep their activations (no ``use_checkpoint``,
        or autograd not recording); else the ``context_fn`` of
        ``torch.utils.checkpoint`` for ``remat_policy`` (torch's no-op one
        for 'full', selective checkpointing for 'dots' and 'dots_all', a
        new ``OffloadSession`` for 'dots_offload')."""
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return None
        policy = self.remat_policy
        if policy == 'full':
            return noop_context_fn
        if policy in REMAT_SAVED_OPS:
            return partial(create_selective_checkpoint_contexts,
                           list(REMAT_SAVED_OPS[policy]))
        if policy == 'dots_offload':
            return OffloadSession()
        raise ValueError(f'unknown remat_policy: {policy!r}')

    def forward(self, x: Tensor, t: Tensor, y: Tensor, grid: Tensor,
                mask: Optional[Tensor] = None, size: Optional[Tensor] = None,
                rope: Optional[RopeTables] = None, train: bool = False,
                force_drop_ids: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: (B, N, p**2*C_in); t: (B,); y: (B,) int; grid: (B, 2, N) int;
        mask: (B, N) or None; size: (B, 1, 2) (h, w) per sample, read by
        online RoPE only. Returns (B, N, p**2*C_out) in the model dtype.

        ``mask=None`` means every token is valid: no key masking and no
        padded-output zeroing (the full-grid sampling case). ``rope``
        passes precomputed ``self.rope(grid, size)`` tables. ``train``,
        ``force_drop_ids`` and ``generator`` drive the label dropout
        (``LabelEmbedder``)."""
        x, c, cos, sin, global_adaln = embed_pre_trunk(
            self, x, t, y, grid, size, rope, train, force_drop_ids,
            generator)
        if self.pipeline is not None:
            x = self.pipeline.run(self, x, c, mask, cos, sin, global_adaln)
            return self.pipeline.output(finalize_post_trunk(self, x, c,
                                                            mask))
        seq = sequence_sharding(self.sequence_mesh, x.shape[1],
                                self.num_heads // self.blocks[0].attn.tp_size)
        if seq is None:
            x = self.run_blocks(self.blocks, x, c, mask, cos, sin,
                                global_adaln)
            out = finalize_post_trunk(self, x, c, mask)
            mesh = self.sequence_mesh
            if mesh is not None and mesh.size('sequence') > 1:
                out = keep_grad(out, mesh.coordinate('sequence') == 0)
            return out
        x = self.run_blocks(self.blocks, seq.split(x), c, mask,
                            seq.split_const(cos), seq.split_const(sin),
                            global_adaln, seq)
        return seq.gather(finalize_post_trunk(self, x, c,
                                              seq.split_const(mask)))

    def run_blocks(self, blocks, x: Tensor, c: Tensor,
                   mask: Optional[Tensor], cos: Optional[Tensor],
                   sin: Optional[Tensor], global_adaln, seq=None) -> Tensor:
        """``blocks`` in order, each checkpointed as ``remat_policy``
        asks where autograd records."""
        context_fn = self._remat()
        for block in blocks:
            if context_fn is not None:
                x = checkpoint(block, x, c, mask, cos, sin, global_adaln,
                               seq, use_reentrant=False,
                               context_fn=context_fn)
            else:
                x = block(x, c, mask, cos, sin, global_adaln, seq)
        return x

    def unpatchify(self, x: Tensor, hw: Tuple[int, int],
                   channel_last: bool = False) -> Tensor:
        """(B, N, p**2*C) -> (B, C, H, W), or (B, H, W, C) with
        channel_last. Channels are inferred from the token dim."""
        h, w = hw
        p = self.patch_size
        c = x.shape[-1] // (p * p)
        x = x.reshape(x.shape[0], h // p, w // p, c, p, p)
        x = torch.einsum('bhwcpq->bhpwqc', x).reshape(x.shape[0], h, w, c)
        return x if channel_last else x.permute(0, 3, 1, 2)


def forward_with_cfg(model: FiT, x: Tensor, t: Tensor, y: Tensor,
                     grid: Tensor, mask: Optional[Tensor],
                     size: Optional[Tensor], cfg_scale: float,
                     scale_pow: float = 0.0,
                     cfg_channels: Optional[int] = None,
                     rope: Optional[RopeTables] = None) -> Tensor:
    """Classifier-free-guidance forward on the doubled (2B) batch whose
    second half carries the null class; x's second half is replaced by the
    first. CFG mixes the first ``cfg_channels`` output channels only
    (default 3 * p**2); the others keep each half's own output. ``rope``
    passes precomputed tables, as to ``FiT.forward``."""
    half = x[: x.shape[0] // 2]
    out = model(torch.cat([half, half], dim=0), t, y, grid, mask, size,
                rope=rope)
    c_cfg = cfg_channels if cfg_channels is not None \
        else 3 * model.patch_size * model.patch_size
    eps, rest = out[..., :c_cfg], out[..., c_cfg:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    if scale_pow == 0.0:
        real_scale = cfg_scale
    else:
        scale_step = (1 - torch.cos(
            ((1 - torch.clamp(t, max=1.0)) ** scale_pow) * torch.pi)) * 0.5
        real_scale = (cfg_scale - 1) * scale_step + 1
        real_scale = real_scale[: x.shape[0] // 2].reshape(-1, 1, 1)
    half_eps = uncond_eps + real_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=-1)
