"""SAM prompt encoder (``ullsam_tpu/models/sam/prompt_encoder.py``).

Points, boxes (as two corner points with labels 2/3), masks, and the uLLSAM
dense prompt from LLM hidden states (parameter-free LayerNorm, then a
learned scalar scale and bias). Label-conditional embeddings are branchless
one-hot arithmetic. Dense outputs are NHWC [B, H, W, d].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ullsam_tpu_torch.core.config import PromptEncoderConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.ops import layers as L

Tensor = torch.Tensor

LABEL_PAD, LABEL_NEG, LABEL_POS, LABEL_BOX_TL, LABEL_BOX_BR = -1, 0, 1, 2, 3


class PositionEmbeddingRandom(nn.Module):
    """The Gaussian frequency matrix is a parameter, as in the JAX package,
    whose train step updates it (the reference keeps it as a buffer); the
    state-dict name is the same either way."""

    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.empty(2, d // 2, device=device, dtype=dtype))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.positional_encoding_gaussian_matrix.normal_(generator=gen)

    def encode(self, coords01: Tensor) -> Tensor:
        """Fourier features of coords in [0, 1]^2 -> [..., d] (f32)."""
        coords = (2.0 * coords01 - 1.0).float()
        proj = coords @ self.positional_encoding_gaussian_matrix.float()
        proj = (2.0 * math.pi) * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    """Names follow the reference: ``pe_layer``, ``point_embeddings.{0..3}``,
    ``not_a_point_embed``, ``no_mask_embed``, ``mask_downscaling.{0,1,3,4,6}``,
    ``llm_scale_factor``, ``llm_bias``; on the GPU unless ``device`` says
    otherwise."""

    def __init__(self, cfg: PromptEncoderConfig, *, device="cuda",
                 dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        d, c = cfg.embed_dim, cfg.mask_in_chans
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(d, **kw)
        self.point_embeddings = nn.ModuleList(
            L.Embedding(1, d, **kw) for _ in range(4))
        self.not_a_point_embed = L.Embedding(1, d, **kw)
        self.no_mask_embed = L.Embedding(1, d, **kw)
        self.mask_downscaling = nn.ModuleList([
            L.Conv2d(1, c // 4, 2, stride=2, **kw),
            L.LayerNorm(c // 4, eps=cfg.ln_eps, **kw),
            nn.Identity(),
            L.Conv2d(c // 4, c, 2, stride=2, **kw),
            L.LayerNorm(c, eps=cfg.ln_eps, **kw),
            nn.Identity(),
            L.Conv2d(c, d, 1, **kw),
        ])
        self.llm_scale_factor = nn.Parameter(torch.full((1,), 0.1, **kw))
        self.llm_bias = nn.Parameter(torch.zeros(1, **kw))

    def get_dense_pe(self) -> Tensor:
        """Dense grid PE [1, H, W, d] (f32)."""
        h, w = self.cfg.image_embedding_size
        dev = self.llm_bias.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(y, x, indexing="ij")
        return self.pe_layer.encode(torch.stack([gx, gy], dim=-1))[None]

    def embed_points(self, coords: Tensor, labels: Tensor) -> Tensor:
        """coords [B, N, 2] (x, y pixels), labels [B, N] in {-1..3}."""
        h, w = self.cfg.input_image_size
        xy = coords.float() + 0.5
        pe = self.pe_layer.encode(
            torch.stack([xy[..., 0] * (1.0 / w), xy[..., 1] * (1.0 / h)], -1))
        is_pad = (labels == LABEL_PAD)[..., None]
        pe = torch.where(is_pad, 0.0, pe)
        pe = pe + torch.where(is_pad,
                              self.not_a_point_embed.weight[0].float(), 0.0)
        onehot = F.one_hot(labels.clamp(0, 3).long(), 4).float()
        onehot = torch.where(is_pad, 0.0, onehot)
        table = torch.cat([e.weight for e in self.point_embeddings]).float()
        return pe + onehot @ table

    def embed_masks(self, masks: Tensor) -> Tensor:
        """masks [B, 4H, 4W, 1] -> dense [B, H, W, d]."""
        m = self.mask_downscaling
        x = L.gelu(m[1](m[0](masks)))
        x = L.gelu(m[4](m[3](x)))
        return m[6](x)

    def embed_llm_hidden(self, llm_hidden: Tensor) -> Tensor:
        """LLM dense prompt [B, H, W, d] -> LN (no affine) * scale + bias."""
        x = L.layer_norm_noparam(llm_hidden, eps=1e-5)
        return (x * self.llm_scale_factor.to(x.dtype)
                + self.llm_bias.to(x.dtype))

    def forward(self, points: Optional[Tuple[Tensor, Tensor]] = None,
                boxes: Optional[Tensor] = None,
                masks: Optional[Tensor] = None,
                llm_hidden: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        """Returns (sparse [B, N, d], dense [B, H, W, d])."""
        cfg = self.cfg
        batch = 1
        for ref in (points[0] if points is not None else None, boxes, masks,
                    llm_hidden):
            if ref is not None:
                batch = ref.shape[0]
                break
        dev = self.llm_bias.device
        parts = []
        if points is not None:
            coords, labels = points
            if boxes is None:
                coords = torch.cat(
                    [coords, coords.new_zeros((batch, 1, 2))], dim=1)
                labels = torch.cat(
                    [labels, labels.new_full((batch, 1), LABEL_PAD)], dim=1)
            parts.append(self.embed_points(coords, labels))
        if boxes is not None:
            corners = boxes.reshape(boxes.shape[0], 2, 2)
            corner_labels = torch.tensor(
                [LABEL_BOX_TL, LABEL_BOX_BR], device=dev).expand(
                    corners.shape[0], 2)
            parts.append(self.embed_points(corners, corner_labels))
        sparse = (torch.cat(parts, dim=1) if parts else
                  torch.zeros((batch, 0, cfg.embed_dim), device=dev))
        if masks is not None:
            dense = self.embed_masks(masks)
        elif llm_hidden is not None:
            dense = self.embed_llm_hidden(llm_hidden)
        else:
            h, w = cfg.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
                batch, h, w, cfg.embed_dim)
        return sparse, dense
