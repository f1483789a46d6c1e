"""FiTLwD: layer-wise flows / blockwise flow matching (the LwD family).

Counterpart of fitv2_tpu/models/fit_lwd.py, for sampling:

  - the depth is split into K = ``number_of_perflow`` segments;
    ``sigmas = linspace(0, 1, K + 1)`` (float64 numpy, as in JAX); segment
    i is a flow over [sigma_i, sigma_{i+1}];
  - one segment's forward (``forward_run_layer``): embed -> [the shared
    trunk] -> that segment's blocks -> its final layer, plus the REPA
    projection of the segment's representation blocks;
  - sampling runs the segments in order, each with
    ``number_of_step_perflow`` Euler sub-steps x <- x + dt * v: a plain
    loop where JAX scans (the scanned form's t and dt are float32, the
    unrolled form's dt the float64 difference rounded once, as in JAX);
  - the SDE samplers take their normal draws from ``noise`` (a callable of
    the shape, or a sequence of tensors taken in order: the tests replay
    JAX's ``jax.random`` draws through it) or else from ``generator`` (a
    CPU ``torch.Generator`` by default, so a seed draws the same numbers
    on any device).

A block stack is an ``nn.ModuleList`` of the port's ``FiTBlock`` (JAX scans
stacked (L, ...) leaves). Every block runs the port's kernels as the FiT's
do: K1 where the conditioning is a (B, D) row, K2 for no-affine LayerNorm
q/k, K4 when both are, K3 otherwise. On a full grid the mask is statically
absent (no key masking, no output zeroing: the same values).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from fitv2_tpu_torch.models import rope as rope_lib
from fitv2_tpu_torch.models.fit import FiT
from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
from fitv2_tpu_torch.models.modules import (
    AdaLNModulation, FiTBlock, FinalLayer, LabelEmbedder, PatchEmbedder,
    TimestepEmbedder)
from fitv2_tpu_torch.models.modules_lwd import (
    SRN, TimestepDependentCoefficient)
from fitv2_tpu_torch.parallel.comms import keep_grad
from fitv2_tpu_torch.parallel.mesh import sequence_sharding

Tensor = torch.Tensor
Noise = Union[None, Callable[[Tuple[int, ...]], Tensor], Sequence[Tensor]]


def noise_source(noise: Noise, generator: Optional[torch.Generator],
                 device: torch.device) -> Callable[[Tuple[int, ...]], Tensor]:
    """``draw(shape)``: a float32 standard normal on ``device``, from
    ``noise`` (a callable of the shape, or a sequence of tensors taken in
    order) or else from ``generator`` (a fresh CPU generator's stream when
    None). CPU draws reach a card through pinned memory, without a stream
    synchronisation."""
    if callable(noise):
        return lambda shape: noise(shape).to(device, torch.float32)
    if noise is not None:
        it = iter(noise)
        return lambda shape: next(it).to(device, torch.float32).reshape(shape)
    gen_device = generator.device if generator is not None else \
        torch.device('cpu')

    def draw(shape):
        w = torch.randn(shape, generator=generator, device=gen_device)
        if w.device == device:
            return w
        if device.type == 'cuda' and w.device.type == 'cpu':
            return w.pin_memory().to(device, non_blocking=True)
        return w.to(device)
    return draw


def _lecun_normal_(weight: Tensor) -> Tensor:
    """flax's default Dense kernel init: a normal of variance 1/fan_in
    truncated at two standard deviations (of the untruncated normal)."""
    std = (1.0 / weight.shape[1]) ** 0.5 / .87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class BlockStack(nn.ModuleList):
    """``length`` FiTBlocks run in order."""

    def __init__(self, length: int, **block_kwargs):
        super().__init__([FiTBlock(**block_kwargs) for _ in range(length)])

    def forward(self, x: Tensor, c: Tensor, mask: Optional[Tensor],
                freqs_cos: Optional[Tensor], freqs_sin: Optional[Tensor],
                global_adaln: Union[Tensor, float] = 0.0,
                seq=None) -> Tensor:
        for block in self:
            x = block(x, c, mask, freqs_cos, freqs_sin, global_adaln, seq)
        return x


class ProjectionHead(nn.Module):
    """REPA projection D -> 2048 -> 2048 -> ``out_dim`` with SiLUs
    (flax's default Dense init)."""

    def __init__(self, in_dim: int, out_dim: int = 1024, hidden: int = 2048):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, out_dim)
        for fc in (self.fc1, self.fc2, self.fc3):
            _lecun_normal_(fc.weight)
            nn.init.zeros_(fc.bias)

    def forward(self, x: Tensor) -> Tensor:
        x = nn.functional.silu(self.fc1(x))
        x = nn.functional.silu(self.fc2(x))
        return self.fc3(x)


class FiTLwD(nn.Module):
    """Segmented FiT; keyword arguments as the JAX FiTLwD's.

    ``dtype`` is the compute dtype the parameters are stored in (a
    torch.dtype or its name, e.g. ``'bfloat16'`` from a YAML config).
    ``gemm_precision='int8'`` makes every block stack's qkv, proj and MLP
    GEMMs int8 W8A8 (``Int8Linear``), as the JAX model's ``quantized``
    block kwarg does: dynamic per-row activation scales until
    ``kernels.quant.calibrate_quant_scales(model, [args])`` runs
    ``model(*args)`` (``init_all``) and binds each site's scale, then the
    serving GEMMs (K6, and K7 at the SwiGLU). ``add_rel_pe_to_v`` makes
    ``rope_layout`` 'interleaved', as in JAX. ``sequence_mesh`` splits
    each segment's and representation trunk's tokens over its sequence
    axis after the patch embedder, as ``FiT``'s: the blocks, the final
    layer and the REPA head run on this rank's tokens and their outputs
    are gathered whole (unsplit where N or the heads do not divide, with
    the gradient kept on sequence rank 0). ``use_checkpoint`` and
    ``use_sit`` do not change a forward pass and are accepted for config
    compatibility.
    """

    def __init__(self, context_size: int = 256, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152,
                 depth: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 1000,
                 learn_sigma: bool = False, use_sit: bool = True,
                 use_checkpoint: bool = False, use_swiglu: bool = True,
                 use_swiglu_large: bool = False,
                 rel_pos_embed: Optional[str] = 'rope',
                 norm_type: str = 'layernorm',
                 q_norm: Optional[str] = 'layernorm',
                 k_norm: Optional[str] = 'layernorm',
                 qk_norm_weight: bool = False, qkv_bias: bool = True,
                 ffn_bias: bool = True, adaln_bias: bool = True,
                 adaln_type: str = 'lora',
                 adaln_lora_dim: Optional[int] = None,
                 rope_theta: float = 10000.0, custom_freqs: str = 'normal',
                 max_pe_len_h: Optional[int] = None,
                 max_pe_len_w: Optional[int] = None, decouple: bool = False,
                 ori_max_pe_len: Optional[int] = None,
                 online_rope: bool = False, add_rel_pe_to_v: bool = False,
                 time_shifting: float = 1.0, number_of_perflow: int = 4,
                 perlayer_embedder: bool = False,
                 number_of_shared_blocks: int = 0,
                 number_of_representation_blocks: int = 0,
                 repa_dim: int = 1024, fourier_basis: bool = False,
                 n_patch_h: int = 16, n_patch_w: int = 16,
                 max_cached_len: int = 256,
                 dtype: Union[torch.dtype, str] = torch.float32,
                 attn_impl: str = 'auto', rope_layout: str = 'split',
                 gemm_precision: str = 'bf16', sequence_mesh: Any = None):
        super().__init__()
        if gemm_precision not in ('bf16', 'int8'):
            raise ValueError(f'gemm_precision={gemm_precision!r}')
        if depth % number_of_perflow:
            raise ValueError(f'depth {depth} does not split into '
                             f'{number_of_perflow} segments')
        if rope_layout not in ('split', 'interleaved'):
            raise ValueError(f'rope_layout={rope_layout!r}')
        if add_rel_pe_to_v:  # as FiT: the interleaved layout throughout
            rope_layout = 'interleaved'
        self.context_size = context_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.learn_sigma = learn_sigma
        self.use_checkpoint = use_checkpoint
        self.rel_pos_embed = rel_pos_embed
        self.adaln_type = adaln_type
        self.time_shifting = time_shifting
        self.number_of_perflow = number_of_perflow
        self.perlayer_embedder = perlayer_embedder
        self.number_of_shared_blocks = number_of_shared_blocks
        self.number_of_representation_blocks = \
            number_of_representation_blocks
        self.repa_dim = repa_dim
        self.fourier_basis = fourier_basis
        self.n_patch_h, self.n_patch_w = n_patch_h, n_patch_w
        self.rope_layout = rope_layout
        self.gemm_precision = gemm_precision
        self.sequence_mesh = sequence_mesh
        self.rope_config = rope_lib.RopeConfig(
            head_dim=hidden_size // num_heads, mode=custom_freqs,
            theta=rope_theta, max_cached_len=max_cached_len,
            max_pe_len_h=max_pe_len_h, max_pe_len_w=max_pe_len_w,
            decouple=decouple, ori_max_pe_len=ori_max_pe_len,
            online=online_rope, layout=rope_layout)
        self._rope_cache: Dict[Any, Dict[str, Tensor]] = {}
        self.block_kwargs = dict(
            hidden_size=hidden_size, num_heads=num_heads,
            mlp_ratio=mlp_ratio, swiglu=use_swiglu,
            swiglu_large=use_swiglu_large, norm_layer=norm_type,
            q_norm=q_norm, k_norm=k_norm, qk_norm_weight=qk_norm_weight,
            qkv_bias=qkv_bias, ffn_bias=ffn_bias, adaln_bias=adaln_bias,
            adaln_type=adaln_type, adaln_lora_dim=adaln_lora_dim,
            use_rope=rel_pos_embed is not None,
            add_rel_pe_to_v=add_rel_pe_to_v, attn_impl=attn_impl,
            rope_layout=rope_layout, quantized=gemm_precision == 'int8')

        K, D = number_of_perflow, hidden_size
        token_dim = patch_size ** 2 * in_channels
        n_emb = K if perlayer_embedder else 1
        self.x_embedders = nn.ModuleList(
            [PatchEmbedder(token_dim, D) for _ in range(n_emb)])
        self.t_embedders = nn.ModuleList(
            [TimestepEmbedder(D) for _ in range(n_emb)])
        self.y_embedders = nn.ModuleList(
            [LabelEmbedder(num_classes, D, class_dropout_prob)
             for _ in range(n_emb)])
        fl_out = self.out_channels * (2 if fourier_basis else 1)
        self.final_layers = nn.ModuleList([FinalLayer(
            D, patch_size, fl_out, norm_layer=norm_type,
            adaln_bias=adaln_bias, adaln_type=adaln_type)
            for _ in range(n_emb)])
        self.segments = nn.ModuleList(
            [BlockStack(self.layers_per_flow, **self.block_kwargs)
             for _ in range(K)])
        if number_of_shared_blocks > 0:
            self.start_shared_blocks = BlockStack(number_of_shared_blocks,
                                                  **self.block_kwargs)
        if adaln_type == 'lora':
            self.global_adaLN_modulation = AdaLNModulation(
                D, 6, adaln_type='normal', bias=adaln_bias)
        if self.rep_layers_per_flow > 0:
            self.representation_x_embedder = PatchEmbedder(token_dim, D)
            self.rep_segments = nn.ModuleList(
                [BlockStack(self.rep_layers_per_flow, **self.block_kwargs)
                 for _ in range(K)])
            self.linear_projection = ProjectionHead(D, repa_dim)
        if fourier_basis:
            # a t_next-conditioned [cos || sin] basis; the final layers'
            # outputs are its coefficients
            self.fourier_basis_embedder = TimestepEmbedder(
                2 * patch_size ** 2 * self.out_channels)
        self._add_modules()
        self._init_weights()
        self.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)

    def _add_modules(self) -> None:
        """Subclasses add their modules here, before the weights are
        initialised."""

    def _init_weights(self) -> None:
        """The JAX package's initialisers: xavier-uniform Linear weights with
        zero bias, N(0, 0.02) timestep MLPs, zero adaLN output layers and
        zero final projections; the REPA heads and the forecaster's
        coefficient and gate keep the initialisation their modules give
        them."""
        zero, normal, own = set(), set(), set()
        for m in self.modules():
            if isinstance(m, AdaLNModulation):
                zero.add(id(m.fc2 if m.adaln_type == 'swiglu' else m.fc_out))
            elif isinstance(m, FinalLayer):
                zero.add(id(m.linear))
            elif isinstance(m, TimestepEmbedder):
                normal |= {id(m.mlp_0), id(m.mlp_2)}
            elif isinstance(m, ProjectionHead):
                own |= {id(m.fc1), id(m.fc2), id(m.fc3)}
            elif isinstance(m, TimestepDependentCoefficient):
                own.add(id(m.fc2))
            elif isinstance(m, SRN):
                own.add(id(m.linear))
        for m in self.modules():
            if not isinstance(m, nn.Linear) or id(m) in own:
                continue
            if id(m) in zero:
                nn.init.zeros_(m.weight)
            elif id(m) in normal:
                nn.init.normal_(m.weight, std=0.02)
            else:
                nn.init.xavier_uniform_(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)

    # -- properties -----------------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        return self.x_embedders[0].proj.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.x_embedders[0].proj.weight.device

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def layers_per_flow(self) -> int:
        return self.depth // self.number_of_perflow

    @property
    def rep_layers_per_flow(self) -> int:
        if self.number_of_representation_blocks <= 1:
            return 0
        if self.number_of_representation_blocks % self.number_of_perflow:
            raise ValueError('number_of_representation_blocks does not split '
                             'into the segments')
        return self.number_of_representation_blocks // self.number_of_perflow

    @property
    def sigmas(self) -> np.ndarray:
        return np.linspace(0.0, 1.0, self.number_of_perflow + 1)

    # the FiT's cached / online RoPE tables and unpatchify
    rope = FiT.rope
    unpatchify = FiT.unpatchify

    # -- shared helpers -------------------------------------------------------

    def _emb(self, seq: nn.ModuleList, i: int) -> nn.Module:
        return seq[i if self.perlayer_embedder else 0]

    def _time_shift(self, t: Tensor) -> Tensor:
        ts = self.time_shifting
        return torch.clamp(ts * t / (1.0 + (ts - 1.0) * t), max=1.0)

    def _cond(self, i: int, t: Tensor, y_embed: Tensor):
        """(c, the global adaLN term, t_emb) at segment i."""
        t_emb = self._emb(self.t_embedders, i)(
            self._time_shift(t).to(self.dtype))
        c = t_emb + y_embed
        g = (self.global_adaLN_modulation(c) if self.adaln_type == 'lora'
             else 0.0)
        return c, g, t_emb

    def _segment_body(self, i: int, x_tokens: Tensor, c: Tensor,
                      mask: Optional[Tensor], f_cos, f_sin, global_adaln,
                      t_next: Optional[Tensor] = None) -> Tensor:
        """embed -> [shared trunk] -> segment blocks -> final layer."""
        h = self._emb(self.x_embedders, i)(x_tokens.to(self.dtype))
        h, f_cos, f_sin, seq = self._split_tokens(h, f_cos, f_sin)
        if self.number_of_shared_blocks > 0:
            h = self.start_shared_blocks(h, c, mask, f_cos, f_sin,
                                         global_adaln, seq)
        h = self.segments[i](h, c, mask, f_cos, f_sin, global_adaln, seq)
        out = self._emb(self.final_layers, i)(h, c)
        if self.fourier_basis:
            if t_next is None:
                raise ValueError('a fourier_basis model needs t_next')
            basis = self.fourier_basis_embedder(t_next.to(self.dtype))
            cos_b, sin_b = basis[:, None, :].chunk(2, dim=-1)
            coeff_cos, coeff_sin = out.chunk(2, dim=-1)
            out = coeff_cos * cos_b + coeff_sin * sin_b
        if mask is not None:
            out = out * self._local(mask, seq).to(out.dtype)[..., None]
        return self._gather_tokens(out, seq)

    def _rep_forward(self, i: int, x_tokens: Tensor, c: Tensor, mask,
                     f_cos, f_sin, global_adaln) -> Tensor:
        r = self.representation_x_embedder(x_tokens.to(self.dtype))
        r, f_cos, f_sin, seq = self._split_tokens(r, f_cos, f_sin)
        r = self.rep_segments[i](r, c, mask, f_cos, f_sin, global_adaln,
                                 seq)
        return self._gather_tokens(self.linear_projection(r), seq)

    # -- the token split (sequence_mesh) --------------------------------------

    def _sequence(self, n_tokens: int):
        """The token split of an ``n_tokens`` trunk, or None
        (``parallel.mesh.sequence_sharding``)."""
        return sequence_sharding(self.sequence_mesh, n_tokens,
                                 self.num_heads
                                 // self.segments[0][0].attn.tp_size)

    def _split_tokens(self, h: Tensor, f_cos, f_sin):
        """(h, tables, split) of this rank's tokens where
        ``sequence_mesh`` splits an N-token trunk, else as given with
        split None."""
        seq = self._sequence(h.shape[1])
        if seq is None:
            return h, f_cos, f_sin, None
        return (seq.split(h), seq.split_const(f_cos), seq.split_const(f_sin),
                seq)

    @staticmethod
    def _local(mask: Tensor, seq) -> Tensor:
        return mask if seq is None else seq.split_const(mask)

    def _gather_tokens(self, out: Tensor, seq) -> Tensor:
        """A trunk's per-token output whole again; unsplit under a
        sequence mesh, its gradient kept on sequence rank 0."""
        if seq is not None:
            return seq.gather(out)
        mesh = self.sequence_mesh
        if mesh is not None and mesh.size('sequence') > 1:
            return keep_grad(out, mesh.coordinate('sequence') == 0)
        return out

    def get_segment_index(self, t: float) -> int:
        """t in [0, 1] -> the segment id."""
        if t >= 1.0:
            return self.number_of_perflow - 1
        return int(t * self.number_of_perflow)

    def _grid(self, batch: int, n_h: Optional[int] = None,
              n_w: Optional[int] = None, context: Optional[int] = None):
        """The mask (None on a full grid) and RoPE tables of a sampler's
        token grid on the model's device."""
        n_h, n_w = n_h or self.n_patch_h, n_w or self.n_patch_w
        context = context or self.context_size
        grid, mask, size = make_grid_mask_size(batch, n_h, n_w, context,
                                               self.device)
        f_cos, f_sin = self.rope(grid, size)
        return (None if n_h * n_w == context else mask), f_cos, f_sin

    def _t(self, batch: int, t: float) -> Tensor:
        return torch.full((batch,), float(t), dtype=torch.float32,
                          device=self.device)

    def _segment_sigma_list(self, i: int, nspf: int,
                            maruyama_last: bool = False) -> np.ndarray:
        sig = self.sigmas
        if maruyama_last and i == self.number_of_perflow - 1:
            # the last segment integrates to 1 - 0.04, then one step to 1
            lst = np.linspace(sig[i], 1.0 - 0.04, nspf)
            return np.concatenate([lst, [1.0]])
        return np.linspace(sig[i], sig[i + 1], nspf + 1)

    @staticmethod
    def _euler(x: Tensor, sig: np.ndarray, velocity) -> Tensor:
        """Euler sub-steps over the ladder ``sig`` in JAX's scanned form:
        t, t_next and dt in float32. velocity(x, t, t_next) -> v."""
        s32 = np.asarray(sig, np.float32)
        for a, b in zip(s32[:-1], s32[1:]):
            v = velocity(x, float(a), float(b))
            x = x + float(b - a) * v.to(x.dtype)
        return x

    @staticmethod
    def _dt(sig: np.ndarray, s: int) -> float:
        """The unrolled form's step: the float64 difference, rounded once."""
        return float(np.float32(sig[s + 1] - sig[s]))

    # -- one segment (the training unit) --------------------------------------

    def forward_run_layer(self, x: Tensor, t: Tensor, y: Tensor,
                          segment_idx: int, grid: Tensor,
                          mask: Optional[Tensor],
                          size: Optional[Tensor] = None, train: bool = False,
                          force_drop_ids: Optional[Tensor] = None,
                          t_next: Optional[Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[Tensor, Optional[Tensor]]:
        """One segment forward: (velocity, REPA projection or None).
        ``t_next`` (default 1) is read by a fourier_basis model only."""
        f_cos, f_sin = self.rope(grid, size)
        y_embed = self._emb(self.y_embedders, segment_idx)(
            y, train, force_drop_ids, generator)
        c, g, _ = self._cond(segment_idx, t, y_embed)
        repr_proj = None
        if self.rep_layers_per_flow > 0:
            repr_proj = self._rep_forward(segment_idx, x, c, mask, f_cos,
                                          f_sin, g)
        if self.fourier_basis and t_next is None:
            t_next = torch.ones_like(t)
        out = self._segment_body(segment_idx, x, c, mask, f_cos, f_sin, g,
                                 t_next)
        return out, repr_proj

    @staticmethod
    def _segment_drops(force_drop_ids, i: int):
        """Segment i's label drops: one tensor for every segment, or a
        sequence of one a segment."""
        if force_drop_ids is None or isinstance(force_drop_ids, Tensor):
            return force_drop_ids
        return force_drop_ids[i]

    def init_all(self, x: Tensor, t: Tensor, y: Tensor, grid: Tensor,
                 mask: Optional[Tensor], size: Optional[Tensor] = None,
                 force_drop_ids=None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Every segment's training forward in turn (labels dropped as in
        training); returns the last segment's velocity. JAX's ``__call__``:
        int8 calibration runs it, so every block stack sees the inputs."""
        out = None
        for i in range(self.number_of_perflow):
            out, _ = self.forward_run_layer(
                x, t, y, i, grid, mask, size, train=True,
                force_drop_ids=self._segment_drops(force_drop_ids, i),
                generator=generator)
        return out

    forward = init_all

    # -- samplers -------------------------------------------------------------

    def _check_x(self, x: Tensor) -> None:
        if x.device != self.device:
            raise ValueError(f'x is on {x.device}, the model on {self.device}')

    @torch.no_grad()
    def sample(self, x: Tensor, y: Tensor, number_of_step_perflow: int = 1,
               return_intermediates: bool = False,
               return_representations: bool = False):
        """Per-segment Euler without CFG. return_intermediates: also the
        state after each segment (stacked); return_representations: also
        each segment's REPA projection at its first sub-step (stacked, or
        None without representation blocks). Returns x or a tuple."""
        self._check_x(x)
        B = x.shape[0]
        mask, f_cos, f_sin = self._grid(B)
        aux = return_intermediates or return_representations
        intermediates, representations = [], []
        for i in range(self.number_of_perflow):
            y_embed = self._emb(self.y_embedders, i)(y)
            sig = self._segment_sigma_list(i, number_of_step_perflow)
            if not aux:
                def vel(xc, t_s, t_nx_s, i=i, y_embed=y_embed):
                    c, g, _ = self._cond(i, self._t(B, t_s), y_embed)
                    return self._segment_body(i, xc, c, mask, f_cos, f_sin,
                                              g, self._t(B, t_nx_s))
                x = self._euler(x, sig, vel)
                continue
            for s in range(number_of_step_perflow):
                c, g, _ = self._cond(i, self._t(B, sig[s]), y_embed)
                if (return_representations and self.rep_layers_per_flow > 0
                        and s == 0):
                    representations.append(self._rep_forward(
                        i, x, c, mask, f_cos, f_sin, g))
                v = self._segment_body(i, x, c, mask, f_cos, f_sin, g,
                                       self._t(B, sig[s + 1]))
                x = x + self._dt(sig, s) * v.to(x.dtype)
            if return_intermediates:
                intermediates.append(x)
        if not aux:
            return x
        out = (x,)
        if return_intermediates:
            out += (torch.stack(intermediates),)
        if return_representations:
            out += (torch.stack(representations) if representations
                    else None,)
        return out

    def _cfg_inputs(self, y: Tensor):
        """The doubled batch's labels (the second half null) and grid."""
        B = y.shape[0]
        y2 = torch.cat([y, torch.full_like(y, self.num_classes)])
        return (y2,) + self._grid(2 * B)

    @torch.no_grad()
    def sample_cfg(self, x: Tensor, y: Tensor, cfg_scale: float,
                   number_of_step_perflow: int = 1) -> Tensor:
        """CFG on the doubled batch (second half null):
        v = v_uncond + cfg_scale * (v_cond - v_uncond) at every sub-step."""
        self._check_x(x)
        B = x.shape[0]
        y2, mask, f_cos, f_sin = self._cfg_inputs(y)
        for i in range(self.number_of_perflow):
            y_embed = self._emb(self.y_embedders, i)(y2)
            sig = self._segment_sigma_list(i, number_of_step_perflow)

            def vel(xc, t_s, t_nx_s, i=i, y_embed=y_embed):
                c, g, _ = self._cond(i, self._t(2 * B, t_s), y_embed)
                v = self._segment_body(i, torch.cat([xc, xc]), c, mask,
                                       f_cos, f_sin, g,
                                       self._t(2 * B, t_nx_s))
                v_cond, v_uncond = v.chunk(2, dim=0)
                return v_uncond + cfg_scale * (v_cond - v_uncond)
            x = self._euler(x, sig, vel)
        return x

    @staticmethod
    def _sde_step(x32: Tensor, v: Tensor, t_cur: float, dt: float,
                  diffusion: float, cfg_scale: Optional[float]) -> Tensor:
        """x + drift * dt in float32 with drift = v + diffusion / 2 * score,
        score = (t v - x) / max(1 - t, 1e-4); CFG mixes the doubled batch's
        drifts where ``cfg_scale`` is given, else its first half is kept."""
        xin = torch.cat([x32, x32]) if v.shape[0] != x32.shape[0] else x32
        score = (t_cur * v - xin) / max(1.0 - t_cur, 1e-4)
        drift = v + 0.5 * diffusion * score
        if v.shape[0] != x32.shape[0]:
            d_cond, d_uncond = drift.chunk(2, dim=0)
            drift = (d_uncond + cfg_scale * (d_cond - d_uncond)
                     if cfg_scale is not None else d_cond)
        return x32 + drift * dt

    @staticmethod
    def _add_noise(x_next: Tensor, draw, diffusion: float, dt: float
                   ) -> Tensor:
        w = draw(tuple(x_next.shape))
        return x_next + float(np.sqrt(max(diffusion, 0.0))
                              * np.sqrt(abs(dt))) * w

    @torch.no_grad()
    def sample_maruyama_cfg(self, x: Tensor, y: Tensor, cfg_scale: float,
                            number_of_step_perflow: int = 1,
                            guidance_low: float = 0.0,
                            guidance_high: float = 1.0,
                            generator: Optional[torch.Generator] = None,
                            noise: Noise = None) -> Tensor:
        """Per-segment Euler-Maruyama with CFG inside [guidance_low,
        guidance_high]: diffusion 1 - t, a normal draw on every sub-step
        but the very last; the last segment integrates to 0.96, then one
        step to 1."""
        self._check_x(x)
        B = x.shape[0]
        draw = noise_source(noise, generator, x.device)
        y2, mask, f_cos, f_sin = self._cfg_inputs(y)
        K = self.number_of_perflow
        for i in range(K):
            y_embed = self._emb(self.y_embedders, i)(y2)
            sig = self._segment_sigma_list(i, number_of_step_perflow,
                                           maruyama_last=True)
            nsub = len(sig) - 1
            for s in range(nsub):
                t_cur, dt = float(sig[s]), float(sig[s + 1] - sig[s])
                c, g, _ = self._cond(i, self._t(2 * B, t_cur), y_embed)
                v = self._segment_body(
                    i, torch.cat([x, x]), c, mask, f_cos, f_sin, g,
                    self._t(2 * B, sig[s + 1])).float()
                in_window = (cfg_scale > 1.0
                             and guidance_low <= t_cur <= guidance_high)
                diffusion = 1.0 - t_cur
                x_next = self._sde_step(x.float(), v, t_cur, dt, diffusion,
                                        cfg_scale if in_window else None)
                if not (i == K - 1 and s == nsub - 1):
                    x_next = self._add_noise(x_next, draw, diffusion, dt)
                x = x_next.to(x.dtype)
        return x

    # -- the multi-scale sampler ----------------------------------------------

    def sample_block_noise(self, shape: Tuple[int, int, int, int],
                           gamma: float = 1.0 / 3.0,
                           generator: Optional[torch.Generator] = None,
                           noise: Noise = None,
                           device: Optional[torch.device] = None) -> Tensor:
        """Block-correlated noise (B, H, W, C): each 2x2 latent block
        ~ N(0, (1 + gamma) I - gamma 11'), from one standard normal draw
        of shape (B, H/2, W/2, C, 4)."""
        b, hx, wx, ch = shape
        device = device or self.device
        cov = (1 + gamma) * np.eye(4) - gamma * np.ones((4, 4))
        chol = torch.as_tensor(np.linalg.cholesky(cov + 1e-8 * np.eye(4)),
                               dtype=torch.float32, device=device)
        z = noise_source(noise, generator, device)(
            (b, hx // 2, wx // 2, ch, 4))
        z = torch.einsum('...i,ji->...j', z, chol)
        z = z.reshape(b, hx // 2, wx // 2, ch, 2, 2)
        z = torch.einsum('bhwcpq->bhpwqc', z)
        return z.reshape(b, hx, wx, ch)

    def _repatchify(self, img: Tensor) -> Tensor:
        """(B, H, W, C) latent image -> (B, N, p**2 * C) tokens."""
        b, hx, wx, c = img.shape
        p = self.patch_size
        x = img.reshape(b, hx // p, p, wx // p, p, c)
        x = torch.einsum('bhpwqc->bhwcpq', x)
        return x.reshape(b, (hx // p) * (wx // p), c * p * p)

    @torch.no_grad()
    def sample_multiscale(self, x: Tensor, y: Tensor,
                          number_of_step_perflow: int = 1,
                          multi_scale_indices: Tuple[int, ...] = (2, 7),
                          per_blocks: Tuple[int, ...] = (2, 5, 5),
                          gamma: float = 1.0 / 3.0,
                          generator: Optional[torch.Generator] = None,
                          noise: Noise = None) -> Tensor:
        """Coarse-to-fine sampling from x, tokens at n_patch / 4: at each
        segment in ``multi_scale_indices`` unpatchify, upsample 2x
        (nearest), renoise with alpha / beta / the corrected sigma and
        block-correlated noise (one draw a boundary), and go on at the
        finer grid. sum(per_blocks) must be number_of_perflow."""
        self._check_x(x)
        if sum(per_blocks) != self.number_of_perflow:
            raise ValueError(f'per_blocks {per_blocks} must sum to '
                             f'{self.number_of_perflow}')
        draw = noise_source(noise, generator, x.device)
        B, p, C = x.shape[0], self.patch_size, self.out_channels
        n_h, n_w = self.n_patch_h // 4, self.n_patch_w // 4
        sig = np.linspace(0.0, 1.0, len(per_blocks) + 1)
        mask, f_cos, f_sin = self._grid(B, n_h, n_w, n_h * n_w)
        sigma_idx, per_block_idx = 0, 0
        sigma_start, sigma_end = float(sig[0]), float(sig[1])
        for i in range(self.number_of_perflow):
            y_embed = self._emb(self.y_embedders, i)(y)
            if i in multi_scale_indices:
                per_block_idx = 0
                sigma_idx += 1
                sigma_start = float(sig[sigma_idx])
                sigma_end = float(sig[sigma_idx + 1])
                img = x.reshape(B, n_h, n_w, C, p, p)
                img = torch.einsum('bhwcpq->bhpwqc', img).reshape(
                    B, n_h * p, n_w * p, C)
                n_h, n_w = n_h * 2, n_w * 2
                img = img.repeat_interleave(2, dim=1).repeat_interleave(
                    2, dim=2)
                ori = sigma_start
                alpha = 1.0 / (np.sqrt(1 + 1 / gamma) * (1 - ori) + ori)
                beta = alpha * (1 - ori) / np.sqrt(gamma)
                sigma_start = alpha * ori  # the corrected sigma
                block = self.sample_block_noise(tuple(img.shape), gamma,
                                                noise=draw, device=x.device)
                img = float(alpha) * img + float(beta) * block.to(img.dtype)
                x = self._repatchify(img)
                mask, f_cos, f_sin = self._grid(B, n_h, n_w, n_h * n_w)
            frac0 = (per_block_idx % per_blocks[sigma_idx]) \
                / per_blocks[sigma_idx]
            frac1 = ((per_block_idx % per_blocks[sigma_idx]) + 1) \
                / per_blocks[sigma_idx]
            per_block_idx += 1
            s_cur = sigma_start + (sigma_end - sigma_start) * frac0
            s_next = sigma_start + (sigma_end - sigma_start) * frac1
            sub = np.linspace(s_cur, s_next, number_of_step_perflow + 1)
            for s in range(number_of_step_perflow):
                c, g, _ = self._cond(i, self._t(B, sub[s]), y_embed)
                v = self._segment_body(i, x, c, mask, f_cos, f_sin, g,
                                       self._t(B, sub[s + 1]))
                x = x + self._dt(sub, s) * v.to(x.dtype)
        return x


def repa_alignment_loss(proj: Tensor, target: Tensor,
                        mask: Optional[Tensor] = None) -> Tensor:
    """REPA: the negative cosine similarity of projected representation
    tokens and frozen-encoder features, (B,). proj, target: (B, N, D);
    mask: (B, N) or None."""
    p = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-8)
    z = target / (torch.linalg.norm(target, dim=-1, keepdim=True) + 1e-8)
    cos = (p * z).sum(-1)
    if mask is not None:
        cos = (cos * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    else:
        cos = cos.mean(-1)
    return -cos
