"""SAM mask decoder (``ullsam_tpu/models/sam/mask_decoder.py``).

Tokens = [iou token; mask tokens; sparse prompts]; the dense prompt is
added to the image embedding; the TwoWayTransformer refines both; the image
is upscaled 4x by two k = s = 2 transposed convs (per-pixel matmuls, grouped
LayerNorm, GELU) and the masks are hypernetwork dot products. The port keeps
the natural spatial layout: the JAX package's block-column layout is a
Mosaic workaround whose values ``cols_to_spatial`` maps back to these.
Mask logits are [B, M, 4H, 4W].

With one image embedding shared by every prompt (batch 1, as in the
automatic-mask-generation sweep) ``predict_masks_cols`` and
``predict_masks_cols_stats`` run the decoder kernels B5 + B7 and B4
(``ops/kernels/decoder.py``): the counterparts of the JAX package's
functions of the same names, in the spatial layout. With one embedding per
prompt they run the module transformer and then B7 / B6, as the JAX
package runs XLA's transformer and its upscale kernels there. A caller that
decodes many chunks of prompts against one image makes its
``SharedImage`` once (``shared_image``) and passes it to every chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ullsam_tpu_torch.core.config import MaskDecoderConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.models.sam.two_way_transformer import TwoWayTransformer
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import decoder as D

Tensor = torch.Tensor


class SharedImage(NamedTuple):
    """One image's side of the decoder kernels: the packed weights, the
    embedding plus the no-mask prompt ``src`` and its encoding ``pe``
    [H*W, C] at the embedding's dtype, and ``D.image_side`` of them."""
    w: D.Weights
    src: Tensor
    pe: Tensor
    image: D.Weights
    H: int
    W: int


class MaskDecoder(nn.Module):
    """Names follow the reference: ``iou_token``, ``mask_tokens``,
    ``transformer``, ``output_upscaling.{0,1,3}``,
    ``output_hypernetworks_mlps.{i}``, ``iou_prediction_head``; on the GPU
    unless ``device`` says otherwise."""

    def __init__(self, cfg: MaskDecoderConfig, *, device="cuda", dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        d, nm = cfg.transformer_dim, cfg.num_mask_tokens
        self.cfg = cfg
        self.iou_token = L.Embedding(1, d, **kw)
        self.mask_tokens = L.Embedding(nm, d, **kw)
        self.transformer = TwoWayTransformer(cfg, **kw)
        self.output_upscaling = nn.ModuleList([
            L.ConvTranspose2x2(d, d // 4, **kw),
            L.LayerNorm(d // 4, eps=1e-6, **kw),
            nn.Identity(),
            L.ConvTranspose2x2(d // 4, d // 8, **kw),
        ])
        self.output_hypernetworks_mlps = nn.ModuleList(
            L.MLPStack([d, d, d, d // 8], **kw) for _ in range(nm))
        self.iou_prediction_head = L.MLPStack(
            [d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1) + [nm],
            **kw)
        self._packed = None

    def upscale_hypernet(self, keys: Tensor, hyper_in: Tensor, H: int,
                         W: int) -> Tensor:
        """keys [B, H*W, C], hyper_in [B, M, C/8] -> masks [B, M, 4H, 4W].

        Matches ``_upscale_hypernet_cols``: f32 one-pass grouped LN (eps
        1e-6) and erf GELU after the first conv, a dtype-switched GELU on
        the rounded second conv output, f32 sums in the hypernet dot."""
        dt = keys.dtype
        up = self.output_upscaling
        x = keys.reshape(keys.shape[0], H, W, -1)
        u1 = up[0].forward_f32(x)                      # [B, 2H, 2W, C/4]
        m1 = u1.mean(-1, keepdim=True)
        m2 = (u1 * u1).mean(-1, keepdim=True)
        var = (m2 - m1 * m1).clamp_min(0.0)
        u1 = (u1 - m1) * torch.rsqrt(var + 1e-6)
        u1 = u1 * up[1].weight.float() + up[1].bias.float()
        u1 = L.gelu(u1).to(dt)
        u2 = L.gelu(up[3].forward_f32(u1).to(dt))      # [B, 4H, 4W, C/8]
        masks = torch.einsum("bhwc,bmc->bmhw", u2.float(),
                             hyper_in.to(dt).float())
        return masks.to(dt)

    def predict_masks(self, image_embeddings: Tensor, image_pe: Tensor,
                      sparse_prompt: Tensor, dense_prompt: Tensor
                      ) -> Tuple[Tensor, Tensor]:
        """image_embeddings [1|B, H, W, C], image_pe [1, H, W, C], sparse
        [B, N, C], dense [B, H, W, C] -> (masks [B, nm, 4H, 4W],
        iou [B, nm])."""
        nm = self.cfg.num_mask_tokens
        tokens = self._tokens(sparse_prompt)
        src = image_embeddings + dense_prompt.to(image_embeddings.dtype)
        _, H, W, _ = src.shape
        hs, keys = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0, :]
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](hs[:, 1 + i, :])
             for i in range(nm)], dim=1)                # [B, nm, C/8]
        masks = self.upscale_hypernet(keys, hyper_in, H, W)
        return masks, self.iou_prediction_head(iou_token_out)

    def _tokens(self, sparse_prompt: Tensor) -> Tensor:
        """[iou token; mask tokens; sparse prompts] per prompt."""
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        out_tokens = out_tokens[None].expand(sparse_prompt.shape[0], -1, -1)
        return torch.cat([out_tokens.to(sparse_prompt.dtype), sparse_prompt],
                         dim=1)

    def packed_weights(self, dtype: torch.dtype) -> D.Weights:
        """``D.pack_weights`` at ``dtype``, made once and kept until a
        parameter changes (its storage or, in place, its version)."""
        key = (dtype, tuple((p.data_ptr(), p._version)
                            for p in self.parameters()))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, D.pack_weights(self, dtype))
        return self._packed[1]

    def shared_image(self, image_embeddings: Tensor, image_pe: Tensor,
                     dense_prompt: Tensor) -> SharedImage:
        """The kernels' view of one shared image embedding [1, H, W, C]
        with its no-mask dense prompt [1, H, W, C]: once per image."""
        src = image_embeddings + dense_prompt.to(image_embeddings.dtype)
        _, H, W, C = src.shape
        dt = src.dtype
        w = self.packed_weights(dt)
        src, pe = src.reshape(H * W, C), image_pe.reshape(H * W, C).to(dt)
        return SharedImage(w, src, pe, D.image_side(w, src, pe), H, W)

    def _per_image(self, image_embeddings: Tensor, image_pe: Tensor,
                   sparse_prompt: Tensor, dense_prompt: Tensor, m: range):
        """One embedding per prompt: the module transformer, then (packed
        weights, q [B, T, C], keys [B*H*W, C], hyper [B, M, C/8], H, W) for
        B7 / B6."""
        tokens = self._tokens(sparse_prompt)
        src = image_embeddings + dense_prompt.to(image_embeddings.dtype)
        _, H, W, C = src.shape
        q, keys = self.transformer(src, image_pe, tokens)
        hyper = torch.stack([self.output_hypernetworks_mlps[i](q[:, 1 + i])
                             for i in m], dim=1)
        return (self.packed_weights(keys.dtype), q, keys.reshape(-1, C),
                hyper, H, W)

    def predict_masks_cols(self, image_embeddings: Tensor, image_pe: Tensor,
                           sparse_prompt: Tensor, dense_prompt: Tensor,
                           multimask_output: Optional[bool] = None,
                           shared: Optional[SharedImage] = None
                           ) -> Tuple[Tensor, Tensor]:
        """Decode only the selected mask tokens (``multimask_output`` True:
        1..nm-1, False: 0, None: all): (masks [B, M, 4H, 4W], iou [B, M]).
        A shared embedding (batch 1 after the dense prompt; ``shared`` if
        the caller made it) runs B5, the hypernet MLPs and B7; one
        embedding per prompt runs the module transformer and B7."""
        m = mask_range(self.cfg.num_mask_tokens, multimask_output)
        if image_embeddings.shape[0] != 1 or dense_prompt.shape[0] != 1:
            w, q, keys, hyper, H, W = self._per_image(
                image_embeddings, image_pe, sparse_prompt, dense_prompt, m)
        else:
            cfg = self.cfg
            w, src, pe, image, H, W = shared or self.shared_image(
                image_embeddings, image_pe, dense_prompt)
            q, keys = D.two_way_transformer(
                w, src, pe, self._tokens(sparse_prompt).to(src.dtype),
                heads=cfg.transformer_num_heads, eps=cfg.ln_eps, image=image)
            hyper = torch.stack(
                [self.output_hypernetworks_mlps[i](q[:, 1 + i]) for i in m],
                dim=1)
        masks = D.upscale_hypernet(w, keys, hyper, H=H, W=W)
        return masks, self.iou_prediction_head(q[:, 0])[:, m.start:m.stop]

    def predict_masks_cols_stats(self, image_embeddings: Tensor,
                                 image_pe: Tensor, sparse_prompt: Tensor,
                                 dense_prompt: Tensor,
                                 multimask_output: Optional[bool],
                                 thr: float, off: float,
                                 shared: Optional[SharedImage] = None):
        """``predict_masks_cols`` plus (stability [B, M], low-res boxes
        [B, M, 4] xyxy) of the masks at threshold ``thr`` and offset
        ``off``, from the kernel's statistics: a shared embedding runs B4,
        one embedding per prompt the module transformer and B6."""
        cfg = self.cfg
        m = mask_range(cfg.num_mask_tokens, multimask_output)
        if image_embeddings.shape[0] != 1 or dense_prompt.shape[0] != 1:
            w, q, keys, hyper, H, W = self._per_image(
                image_embeddings, image_pe, sparse_prompt, dense_prompt, m)
            masks, counts, rowany, colany = D.upscale_hypernet_stats(
                w, keys, hyper, H=H, W=W, thr=float(thr), off=float(off))
        else:
            w, src, pe, image, H, W = shared or self.shared_image(
                image_embeddings, image_pe, dense_prompt)
            q, masks, counts, rowany, colany = D.decode_masks(
                w, src, pe, self._tokens(sparse_prompt).to(src.dtype), H=H,
                W=W, heads=cfg.transformer_num_heads, eps=cfg.ln_eps,
                m_lo=m.start, M=len(m), thr=float(thr), off=float(off),
                image=image)
        iou = self.iou_prediction_head(q[:, 0])[:, m.start:m.stop]
        return masks, iou, stats_from_kernel(counts, rowany, colany)

    def forward(self, image_embeddings: Tensor, image_pe: Tensor,
                sparse_prompt: Tensor, dense_prompt: Tensor,
                multimask_output: bool) -> Tuple[Tensor, Tensor]:
        masks, iou = self.predict_masks(image_embeddings, image_pe,
                                        sparse_prompt, dense_prompt)
        if multimask_output:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, 0:1], iou[:, 0:1]


def mask_range(nm: int, multimask_output: Optional[bool]) -> range:
    """Selected mask tokens: 1..nm-1 (multimask), 0 (single), or all."""
    if multimask_output is True:
        return range(1, nm)
    if multimask_output is False:
        return range(0, 1)
    return range(nm)


def stats_from_kernel(counts: Tensor, rowany: Tensor, colany: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """(stability [B, M], boxes [B, M, 4] f32 xyxy with inclusive edges,
    zeros for an empty mask) from the statistics of B6 / B4: counts
    [B, M, 2] (hi, lo), rowany [B, M, 4H], colany [B, M, 4W]."""
    hi, lo = counts[..., 0].float(), counts[..., 1].float()
    stability = hi / lo.clamp_min(1.0)
    any_row, any_col = rowany > 0, colany > 0
    rows = torch.arange(any_row.shape[-1], device=counts.device)
    cols = torch.arange(any_col.shape[-1], device=counts.device)
    top = torch.where(any_row, rows, any_row.shape[-1]).amin(-1)
    bottom = torch.where(any_row, rows, -1).amax(-1)
    left = torch.where(any_col, cols, any_col.shape[-1]).amin(-1)
    right = torch.where(any_col, cols, -1).amax(-1)
    empty = ~any_row.any(-1)
    boxes = torch.stack([left, top, right, bottom], dim=-1)
    return stability, torch.where(empty[..., None], 0, boxes).float()
