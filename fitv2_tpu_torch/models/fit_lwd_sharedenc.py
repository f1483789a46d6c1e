"""FiTLwD with a shared representation encoder and separate decoders.

Counterpart of fitv2_tpu/models/fit_lwd_sharedenc.py, for sampling: a
representation encoder shared by every segment (``shared_rep_blocks``)
turns the noisy tokens into per-token features; the decoders' conditioning
becomes per token, c_repre = t_emb[:, None] + rep, through a second global
adaLN head (``global_adaLN_modulation2``); the segment's decoder blocks
then integrate its sub-flow. The encoder's blocks take the (B, D) row and
run K1; the decoders' blocks and final layer take (B, N, D) conditioning
and run the plain modulation chain, as in JAX.

The mid-block forecaster (``mid_blocks``, ``mid_coefficient``,
``mid_gate``) learns, in ``forward_run_layer_finetune``, to forecast the
frozen encoder's representation (the finetune recipe of
train/lwd_train_step.py); JAX's ``stop_gradient`` is ``.detach()`` there.

Under ``sequence_mesh`` (``FiTLwD``'s) ``forward_run_layer`` splits the
tokens after the encoder's and the decoder's patch embedders: the
encoder's representation, the per-token conditioning and the decoder run
on this rank's tokens, and the velocity and the REPA projection are
gathered whole. The finetune forward runs unsplit (its outputs' gradient
on sequence rank 0).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fitv2_tpu_torch.models.fit_lwd import (
    BlockStack, FiTLwD, Noise, ProjectionHead, noise_source)
from fitv2_tpu_torch.models.modules import AdaLNModulation, PatchEmbedder
from fitv2_tpu_torch.models.modules_lwd import (
    SRN, TimestepDependentCoefficient)

Tensor = torch.Tensor


class FiTLwDSharedEncSepDec(FiTLwD):
    """FiTLwD plus the shared encoder and per-token conditioning; keyword
    arguments as the JAX model's (``number_of_representation_blocks`` is
    the encoder's depth here)."""

    def __init__(self, *, number_of_representation_blocks: int = 4,
                 number_of_mid_blocks: int = 1,
                 self_guidance_scale: float = 1.05,
                 self_guidance_scale_global: float = 1.1, **kwargs):
        if number_of_representation_blocks < 1:
            raise ValueError('the shared encoder needs at least one block')
        # plain attributes may be set before nn.Module.__init__; the
        # modules that read them are added inside it (_add_modules)
        self.number_of_mid_blocks = number_of_mid_blocks
        self.self_guidance_scale = self_guidance_scale
        self.self_guidance_scale_global = self_guidance_scale_global
        super().__init__(
            number_of_representation_blocks=number_of_representation_blocks,
            **kwargs)

    @property
    def rep_layers_per_flow(self) -> int:
        return 0  # the encoder is shared, not per segment

    def _add_modules(self) -> None:
        D = self.hidden_size
        token_dim = self.patch_size ** 2 * self.in_channels
        adaln_bias = self.block_kwargs['adaln_bias']
        self.representation_x_embedder2 = PatchEmbedder(token_dim, D)
        self.shared_rep_blocks = BlockStack(
            self.number_of_representation_blocks, **self.block_kwargs)
        self.rep_projection = ProjectionHead(D, self.repa_dim)
        if self.adaln_type == 'lora':
            self.global_adaLN_modulation2 = AdaLNModulation(
                D, 6, adaln_type='normal', bias=adaln_bias)
        self.mid_blocks = BlockStack(self.number_of_mid_blocks,
                                     **self.block_kwargs)
        self.mid_coefficient = TimestepDependentCoefficient(D)
        self.mid_gate = SRN(D, self.patch_size, D, adaln_bias=adaln_bias)

    # -- the shared encoder ---------------------------------------------------

    def _encode_representation(self, x_tokens: Tensor, c: Tensor, mask,
                               f_cos, f_sin, global_adaln,
                               seq=None) -> Tensor:
        r = self.representation_x_embedder2(x_tokens.to(self.dtype))
        if seq is not None:
            r = seq.split(r)
        return self.shared_rep_blocks(r, c, mask, f_cos, f_sin, global_adaln,
                                      seq)

    def _token_cond(self, t_emb: Tensor, rep: Tensor):
        """c_repre = t_emb per token + the representation tokens, and its
        global adaLN term."""
        c_repre = t_emb[:, None, :] + rep
        if self.adaln_type == 'lora':
            return c_repre, self.global_adaLN_modulation2(c_repre)
        return c_repre, 0.0

    def _decode(self, i: int, x_tokens: Tensor, c_repre: Tensor, g2, mask,
                f_cos, f_sin, seq=None) -> Tuple[Tensor, Tensor]:
        """Segment i's decoder: (masked output, pre-final hidden); with
        ``seq``, of this rank's tokens."""
        h = self._emb(self.x_embedders, i)(x_tokens.to(self.dtype))
        if seq is not None:
            h = seq.split(h)
        h = self.segments[i](h, c_repre, mask, f_cos, f_sin, g2, seq)
        out = self._emb(self.final_layers, i)(h, c_repre)
        if mask is not None:
            out = out * self._local(mask, seq).to(out.dtype)[..., None]
        return out, h

    def forward_run_layer(self, x: Tensor, t: Tensor, y: Tensor,
                          segment_idx: int, grid: Tensor,
                          mask: Optional[Tensor],
                          size: Optional[Tensor] = None, train: bool = False,
                          force_drop_ids: Optional[Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[Tensor, Tensor]:
        """One segment with the encoder's conditioning: (velocity, the
        encoder's REPA projection)."""
        f_cos, f_sin = self.rope(grid, size)
        y_embed = self._emb(self.y_embedders, segment_idx)(
            y, train, force_drop_ids, generator)
        c, g, t_emb = self._cond(segment_idx, t, y_embed)
        seq = self._sequence(x.shape[1])
        if seq is not None:
            f_cos, f_sin = seq.split_const(f_cos), seq.split_const(f_sin)
        rep = self._encode_representation(x, c, mask, f_cos, f_sin, g, seq)
        c_repre, g2 = self._token_cond(t_emb, rep)
        out, _ = self._decode(segment_idx, x, c_repre, g2, mask, f_cos,
                              f_sin, seq)
        return (self._gather_tokens(out, seq),
                self._gather_tokens(self.rep_projection(rep), seq))

    def init_all(self, x: Tensor, t: Tensor, y: Tensor, grid: Tensor,
                 mask: Optional[Tensor], size: Optional[Tensor] = None,
                 force_drop_ids=None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """FiTLwD's ``init_all``, then the forecaster's finetune forward at
        segment 0 in each mode (t_next = t, xt_next = x), as in JAX: the
        mid blocks see inputs too."""
        out = super().init_all(x, t, y, grid, mask, size, force_drop_ids,
                               generator)
        for mode in ('replace', 'residual', 'blend'):
            self.forward_run_layer_finetune(x, t, y, 0, grid, mask, t_next=t,
                                            xt_next=x, size=size, mode=mode)
        return out

    forward = init_all

    def forward_run_layer_finetune(self, x: Tensor, t: Tensor, y: Tensor,
                                   segment_idx: int, grid: Tensor,
                                   mask: Optional[Tensor], t_next: Tensor,
                                   xt_next: Tensor,
                                   size: Optional[Tensor] = None,
                                   mode: str = 'replace') -> Dict[str, Tensor]:
        """The mid-block forecaster's training forward: ``rep_t`` stands in
        for the frozen encoder's representation at (t, x), from the
        forecaster fed x and conditioned on t_emb plus the frozen encoder's
        representation at (t_next, xt_next):

          'replace'   rep_t = mid(x)
          'residual'  rep_t = rep + coeff(t_emb) * mid(x)
          'blend'     rep_t = (1 - g) * rep + g * mid(x), g = mid_gate

        Returns x_pred (segment i's decoder on rep_t), x_target and
        rep_target (the frozen full path at (t, x), detached) and rep_pred
        (the REPA projection of rep_t). The labels are not dropped."""
        f_cos, f_sin = self.rope(grid, size)
        i = segment_idx
        y_embed = self._emb(self.y_embedders, i)(y)
        t_emb = self._emb(self.t_embedders, i)(
            self._time_shift(t).to(self.dtype))
        c_next, g_next, _ = self._cond(i, t_next, y_embed)
        rep_frozen = self._encode_representation(
            xt_next, c_next, mask, f_cos, f_sin, g_next).detach()
        x_mid = self.representation_x_embedder2(x.to(self.dtype)).detach()
        c_mid = t_emb[:, None, :] + rep_frozen
        mid_out = self.mid_blocks(x_mid, c_mid, mask, f_cos, f_sin, 0.0)
        if mode == 'replace':
            rep_t = mid_out
        elif mode == 'residual':
            rep_t = rep_frozen + self.mid_coefficient(t_emb)[:, None, :] \
                * mid_out
        elif mode == 'blend':
            gate = self.mid_gate(x_mid, c_mid)
            rep_t = (1.0 - gate) * rep_frozen + gate * mid_out
        else:
            raise ValueError(f'unknown finetune mode: {mode!r}')
        rep_pred = self.rep_projection(rep_t)
        c_repre, g2 = self._token_cond(t_emb, rep_t)
        x_pred, _ = self._decode(i, x, c_repre, g2, mask, f_cos, f_sin)

        c, g, _ = self._cond(i, t, y_embed)
        rep2 = self._encode_representation(x, c, mask, f_cos, f_sin, g)
        rep_target = self.rep_projection(rep2).detach()
        c_repre2, g22 = self._token_cond(t_emb, rep2)
        x_target, _ = self._decode(i, x, c_repre2, g22, mask, f_cos, f_sin)
        return {'x_pred': self._gather_tokens(x_pred, None),
                'x_target': x_target.detach(),
                'rep_pred': self._gather_tokens(rep_pred, None),
                'rep_target': rep_target}

    def _segment_forward(self, i: int, x2: Tensor, t: Tensor, y2: Tensor,
                         mask, f_cos, f_sin, rep_transform=None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
        """One velocity eval: (velocity, encoder representation, pre-final
        hidden). ``rep_transform`` edits the representation before it
        conditions the decoder (self-guidance)."""
        y_embed = self._emb(self.y_embedders, i)(y2)
        c, g, t_emb = self._cond(i, t, y_embed)
        rep = self._encode_representation(x2, c, mask, f_cos, f_sin, g)
        if rep_transform is not None:
            rep = rep_transform(rep)
        c_repre, g2 = self._token_cond(t_emb, rep)
        out, h = self._decode(i, x2, c_repre, g2, mask, f_cos, f_sin)
        return out, rep, h

    def _self_guidance_transform(self, t_cur: float, cfg_scale: float,
                                 guidance_low: float, guidance_high: float,
                                 self_guidance: bool,
                                 scale: Optional[float] = None):
        """Inside the guidance window, the doubled batch's representation
        becomes [r_null + scale (r_cond - r_null), r_null]; else None."""
        if not (self_guidance and cfg_scale > 1.0
                and guidance_low <= t_cur <= guidance_high):
            return None
        scale = self.self_guidance_scale if scale is None else scale

        def transform(rep):
            r_cond, r_null = rep.chunk(2, dim=0)
            return torch.cat([r_null + scale * (r_cond - r_null), r_null])
        return transform

    # -- samplers -------------------------------------------------------------

    @torch.no_grad()
    def sample_cfg(self, x: Tensor, y: Tensor, cfg_scale: float,
                   number_of_step_perflow: int = 1,
                   guidance_low: float = 0.0,
                   guidance_high: float = 1.0) -> Tensor:
        """Per-segment Euler on the doubled batch with CFG where t is in
        [guidance_low, guidance_high] (decided on the float64 ladder), the
        conditional half elsewhere."""
        self._check_x(x)
        B = x.shape[0]
        y2, mask, f_cos, f_sin = self._cfg_inputs(y)
        for i in range(self.number_of_perflow):
            sig = self._segment_sigma_list(i, number_of_step_perflow)
            guided = [cfg_scale > 1.0
                      and guidance_low <= float(s) <= guidance_high
                      for s in sig[:-1]]
            s32 = np.asarray(sig, np.float32)
            for s in range(len(sig) - 1):
                v = self._segment_forward(
                    i, torch.cat([x, x]), self._t(2 * B, s32[s]), y2, mask,
                    f_cos, f_sin)[0]
                v_cond, v_uncond = v.chunk(2, dim=0)
                if guided[s]:
                    v = v_uncond + cfg_scale * (v_cond - v_uncond)
                else:
                    v = v_cond
                x = x + float(s32[s + 1] - s32[s]) * v.to(x.dtype)
        return x

    @torch.no_grad()
    def sample(self, x: Tensor, y: Tensor, number_of_step_perflow: int = 1,
               return_intermediates: bool = False,
               return_representations: bool = False,
               return_semantics: bool = False,
               return_hidden: bool = False):
        """Per-segment Euler without CFG. The flags collect, at every
        sub-step, the state after it ('intermediates'), the encoder's REPA
        projection ('representations'), its raw representation
        ('semantics') and the decoder's pre-final hidden ('hidden').
        Returns x, or (x, dict of the requested lists)."""
        self._check_x(x)
        B = x.shape[0]
        mask, f_cos, f_sin = self._grid(B)
        aux = {k: [] for k, on in [
            ('intermediates', return_intermediates),
            ('representations', return_representations),
            ('semantics', return_semantics),
            ('hidden', return_hidden)] if on}
        for i in range(self.number_of_perflow):
            sig = self._segment_sigma_list(i, number_of_step_perflow)
            if not aux:
                def vel(xc, t_s, t_nx_s, i=i):
                    return self._segment_forward(i, xc, self._t(B, t_s), y,
                                                 mask, f_cos, f_sin)[0]
                x = self._euler(x, sig, vel)
                continue
            for s in range(number_of_step_perflow):
                v, rep, h = self._segment_forward(
                    i, x, self._t(B, sig[s]), y, mask, f_cos, f_sin)
                x = x + self._dt(sig, s) * v.to(x.dtype)
                if 'intermediates' in aux:
                    aux['intermediates'].append(x)
                if 'representations' in aux:
                    aux['representations'].append(self.rep_projection(rep))
                if 'semantics' in aux:
                    aux['semantics'].append(rep)
                if 'hidden' in aux:
                    aux['hidden'].append(h)
        return (x, aux) if aux else x

    @torch.no_grad()
    def sample_maruyama(self, x: Tensor, y: Tensor,
                        number_of_step_perflow: int = 1,
                        return_intermediates: bool = False,
                        generator: Optional[torch.Generator] = None,
                        noise: Noise = None):
        """Per-segment Euler-Maruyama without CFG: the drift carries the
        full (1 - t) score and the draw sqrt(2 (1 - t) dt); the last
        segment's ladder as in ``sample_maruyama_cfg``. Returns x, or
        (x, the state after every sub-step)."""
        self._check_x(x)
        B = x.shape[0]
        draw = noise_source(noise, generator, x.device)
        mask, f_cos, f_sin = self._grid(B)
        K = self.number_of_perflow
        inter = []
        for i in range(K):
            sig = self._segment_sigma_list(i, number_of_step_perflow,
                                           maruyama_last=True)
            nsub = len(sig) - 1
            for s in range(nsub):
                t_cur, dt = float(sig[s]), float(sig[s + 1] - sig[s])
                v = self._segment_forward(i, x, self._t(B, t_cur), y, mask,
                                          f_cos, f_sin)[0].float()
                # 0.5 * 2 (1 - t) is (1 - t) exactly
                diffusion = 2.0 * (1.0 - t_cur)
                x_next = self._sde_step(x.float(), v, t_cur, dt, diffusion,
                                        None)
                if not (i == K - 1 and s == nsub - 1):
                    x_next = self._add_noise(x_next, draw, diffusion, dt)
                x = x_next.to(x.dtype)
                if return_intermediates:
                    inter.append(x)
        return (x, inter) if return_intermediates else x

    @torch.no_grad()
    def sample_maruyama_global_cfg(self, x: Tensor, y: Tensor,
                                   cfg_scale: float, num_steps: int = 250,
                                   guidance_low: float = 0.0,
                                   guidance_high: float = 1.0,
                                   self_guidance: bool = False,
                                   t_end: float = 0.96,
                                   generator: Optional[torch.Generator] = None,
                                   noise: Noise = None) -> Tensor:
        """Euler-Maruyama on one global ladder, ``num_steps`` points over
        [0, t_end] and a last deterministic step to 1: the segment picked
        per step by ``get_segment_index``, diffusion 2 (1 - t), the batch
        doubled only inside the guidance window (with self-guidance at
        ``self_guidance_scale_global`` when asked); the state in float32."""
        self._check_x(x)
        B = x.shape[0]
        draw = noise_source(noise, generator, x.device)
        mask, f_cos, f_sin = self._grid(B)
        y2, mask2, f_cos2, f_sin2 = self._cfg_inputs(y)
        sig = np.concatenate([np.linspace(0.0, t_end, num_steps), [1.0]])

        def step(t_cur: float, dt: float, x32: Tensor):
            i = self.get_segment_index(t_cur)
            doubled = (cfg_scale > 1.0
                       and guidance_low <= t_cur <= guidance_high)
            if doubled:
                tr = self._self_guidance_transform(
                    t_cur, cfg_scale, guidance_low, guidance_high,
                    self_guidance, scale=self.self_guidance_scale_global)
                xin = torch.cat([x32, x32]).to(x.dtype)
                v = self._segment_forward(i, xin, self._t(2 * B, t_cur), y2,
                                          mask2, f_cos2, f_sin2, tr)[0]
            else:
                v = self._segment_forward(i, x32.to(x.dtype),
                                          self._t(B, t_cur), y, mask, f_cos,
                                          f_sin)[0]
            diffusion = 2.0 * (1.0 - t_cur)
            return self._sde_step(x32, v.float(), t_cur, dt, diffusion,
                                  cfg_scale if doubled else None), diffusion

        x32 = x.float()
        for t_cur, t_next in zip(sig[:-2], sig[1:-1]):
            dt = float(t_next - t_cur)
            x32, diffusion = step(float(t_cur), dt, x32)
            x32 = self._add_noise(x32, draw, diffusion, dt)
        x32, _ = step(float(sig[-2]), float(sig[-1] - sig[-2]), x32)
        return x32.to(x.dtype)

    @torch.no_grad()
    def sample_maruyama_cfg(self, x: Tensor, y: Tensor, cfg_scale: float,
                            number_of_step_perflow: int = 1,
                            guidance_low: float = 0.0,
                            guidance_high: float = 1.0,
                            self_guidance: bool = False,
                            generator: Optional[torch.Generator] = None,
                            noise: Noise = None) -> Tensor:
        """Per-segment Euler-Maruyama with guidance windows, as FiTLwD's,
        with representation self-guidance (``self_guidance_scale``) inside
        the window when asked."""
        self._check_x(x)
        B = x.shape[0]
        draw = noise_source(noise, generator, x.device)
        y2, mask, f_cos, f_sin = self._cfg_inputs(y)
        K = self.number_of_perflow
        for i in range(K):
            sig = self._segment_sigma_list(i, number_of_step_perflow,
                                           maruyama_last=True)
            nsub = len(sig) - 1
            for s in range(nsub):
                t_cur, dt = float(sig[s]), float(sig[s + 1] - sig[s])
                tr = self._self_guidance_transform(
                    t_cur, cfg_scale, guidance_low, guidance_high,
                    self_guidance)
                v = self._segment_forward(
                    i, torch.cat([x, x]), self._t(2 * B, t_cur), y2, mask,
                    f_cos, f_sin, tr)[0].float()
                in_window = (cfg_scale > 1.0
                             and guidance_low <= t_cur <= guidance_high)
                diffusion = 1.0 - t_cur
                x_next = self._sde_step(x.float(), v, t_cur, dt, diffusion,
                                        cfg_scale if in_window else None)
                if not (i == K - 1 and s == nsub - 1):
                    x_next = self._add_noise(x_next, draw, diffusion, dt)
                x = x_next.to(x.dtype)
        return x
