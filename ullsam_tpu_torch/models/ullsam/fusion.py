"""uLLSAM fusion model: SAM vision tower <-> InternLM2
(``ullsam_tpu/models/ullsam/fusion.py:44-298``).

The SAM 64x64x256 feature map is pixel-shuffled (ds = 0.5) to 1024 visual
tokens, projected by mlp1 into the LLM embedding space and scattered into
the <IMG_CONTEXT> positions; the LLM's final hidden states over those
positions go back through mlp2 and the inverse shuffle to a 64x64x256 dense
SAM prompt. Layouts: pixel_values NHWC [B, 1024, 1024, 3]; SAM features and
the dense prompt NHWC [B, 64, 64, 256].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ullsam_tpu_torch.core.config import FusionConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.models.internlm2 import model as LLM
from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
from ullsam_tpu_torch.models.sam.mask_decoder import MaskDecoder
from ullsam_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.parallel.distributed import (copy_to_model,
                                                   global_denominator,
                                                   row_parallel_linear)

Tensor = torch.Tensor


class ProjMLP(nn.Sequential):
    """LN -> Linear -> GELU -> Linear, as the reference's Sequential
    (parameters at indices 0, 1 and 3). Under a mesh ``tp``
    (``shard_params``) fc1 holds this rank's hidden units and fc2 their
    input columns, its product summed over the model group."""

    tp = None

    def __init__(self, in_dim: int, mid: int, out: int, eps: float, *,
                 device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        super().__init__(L.LayerNorm(in_dim, eps=eps, **kw),
                         L.Linear(in_dim, mid, **kw), nn.Identity(),
                         L.Linear(mid, out, **kw))

    def forward(self, x: Tensor) -> Tensor:
        h = L.gelu(self[1](copy_to_model(self[0](x), self.tp)))
        return row_parallel_linear(self[3], h, self.tp)


class Fusion(nn.Module):
    """``vision_model``, ``language_model``, ``mlp1``, ``mlp2``."""

    def __init__(self, cfg: FusionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        vd, hd = cfg.vision_token_dim, cfg.llm.hidden_size
        self.vision_model = ImageEncoder(cfg.sam.vit, **kw)
        self.language_model = LLM.InternLM2ForCausalLM(cfg.llm, **kw)
        self.mlp1 = ProjMLP(vd, hd, hd, cfg.ln_eps, **kw)
        self.mlp2 = ProjMLP(hd, vd, vd, cfg.ln_eps, **kw)


class ULLSAM(nn.Module):
    """The whole model under the reference checkpoint names: ``fusion.*``,
    ``prompt_encoder.*``, ``mask_decoder.*``. Built on the GPU unless
    ``device`` says otherwise; weights come from ``load_state_dict``."""

    def __init__(self, cfg: FusionConfig, *, device="cuda", dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.cfg = cfg
        self.fusion = Fusion(cfg, **kw)
        self.prompt_encoder = PromptEncoder(cfg.sam.prompt_encoder, **kw)
        self.mask_decoder = MaskDecoder(cfg.sam.mask_decoder, **kw)


def build_ullsam(cfg: FusionConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 seed: int = 0) -> ULLSAM:
    """A model with random weights drawn from ``torch.Generator(seed)`` on
    ``device`` (default: the GPU)."""
    device = resolve_device(device)
    model = ULLSAM(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L.init_module_(model, gen)
    return model.eval()


# ---------------------------------------------------------------------------
# pixel shuffle and its inverse
# ---------------------------------------------------------------------------


def pixel_shuffle(x: Tensor, scale: float, ps_version: str = "v2") -> Tensor:
    """[N, H, W, C] -> [N, H*s, W*s, C/s^2] in the InternVL shuffle order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, int(w * scale), int(c / scale)).transpose(1, 2)
    x = x.reshape(n, int(w * scale), int(h * scale),
                  int(c / (scale * scale)))
    if ps_version != "v1":
        x = x.transpose(1, 2)
    return x.contiguous()


def pixel_unshuffle(x: Tensor, scale: float, ps_version: str = "v2") -> Tensor:
    """Inverse of pixel_shuffle: [N, h, w, c] -> [N, h/s, w/s, c*s^2]."""
    if ps_version != "v1":
        x = x.transpose(1, 2)
    n, h, w, c = x.shape
    x = x.reshape(n, h, int(w / scale), int(c * scale)).transpose(1, 2)
    return x.reshape(n, int(w / scale), int(h / scale),
                     int(c * scale * scale)).contiguous()


# ---------------------------------------------------------------------------
# feature extraction, scatter, gather
# ---------------------------------------------------------------------------


def extract_feature(model: ULLSAM, cfg: FusionConfig, pixel_values: Tensor,
                    stop_vision_gradient: bool = True,
                    remat: bool = False) -> Tuple[Tensor, Tensor]:
    """pixel_values [B, S, S, 3] -> (vit_tokens [B, T, llm_hidden],
    sam_features [B, 64, 64, 256]); computed in the vision tower's dtype.
    ``stop_vision_gradient`` detaches the features (no gradient reaches the
    tower); ``remat`` checkpoints the tower's blocks."""
    vm = model.fusion.vision_model
    feats = vm(pixel_values.to(vm.patch_embed.proj.weight.dtype),
               remat=remat)
    if stop_vision_gradient:
        feats = feats.detach()
    x = pixel_shuffle(feats, cfg.downsample_ratio, cfg.ps_version)
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    return model.fusion.mlp1(x), feats


def scatter_image_embeds(input_ids: Tensor, input_embeds: Tensor,
                         vit_tokens: Tensor, context_token_id: int) -> Tensor:
    """Replace <IMG_CONTEXT> positions with visual tokens, consumed in
    order over the flattened token stream; more context tokens than visual
    tokens wrap around (the reference's repeat-on-overflow)."""
    B, N, C = input_embeds.shape
    flat_vit = vit_tokens.reshape(-1, C)
    sel = input_ids.reshape(-1) == context_token_id
    idx = torch.remainder(torch.cumsum(sel.long(), 0) - 1, flat_vit.shape[0])
    gathered = flat_vit[idx].to(input_embeds.dtype)
    out = torch.where(sel[:, None], gathered, input_embeds.reshape(B * N, C))
    return out.reshape(B, N, C)


def gather_image_hidden(input_ids: Tensor, hidden: Tensor,
                        context_token_id: int,
                        num_image_token: int) -> Tensor:
    """Per-row slice of the contiguous image-token run: [B, N, H] ->
    [B, num_image_token, H] (start clamped like a dynamic slice)."""
    B, N, _ = hidden.shape
    starts = (input_ids == context_token_id).int().argmax(dim=-1)
    starts = starts.clamp(max=N - num_image_token)
    idx = starts[:, None] + torch.arange(num_image_token,
                                         device=hidden.device)[None]
    return hidden[torch.arange(B, device=hidden.device)[:, None], idx]


def text_aware_dense_feature(model: ULLSAM, cfg: FusionConfig,
                             image_hidden: Tensor) -> Tensor:
    """LLM hidden states over image tokens [B, T, H] -> dense SAM prompt
    [B, 64, 64, 256] NHWC."""
    x = model.fusion.mlp2(image_hidden)
    s = cfg.shuffled_hw
    x = x.reshape(x.shape[0], s, s, x.shape[-1])
    return pixel_unshuffle(x, cfg.downsample_ratio, cfg.ps_version)


def fusion_forward(model: ULLSAM, cfg: FusionConfig, pixel_values: Tensor,
                   input_ids: Tensor,
                   attention_mask: Optional[Tensor] = None,
                   labels: Optional[Tensor] = None,
                   segment_ids: Optional[Tensor] = None,
                   output_dense_prompt: bool = False,
                   stop_vision_gradient: bool = True, remat: bool = False,
                   remat_llm: Optional[bool] = None) -> dict:
    """One fused forward (``fusion.py:187-256``). Returns {'logits'
    [B, N, V], 'image_embeddings' [B, 64, 64, 256], and 'loss' (CE with
    shift, ignore -100) when labels are given, 'dense_prompt'
    [B, 64, 64, 256] when asked}. Under grad: ``stop_vision_gradient``
    keeps gradients out of the vision tower, ``remat`` checkpoints its
    blocks and ``remat_llm`` (default: ``remat``) the LLM's layers.

    ``segment_ids`` [B, N] (0 = padding) is the packed-rows mode: several
    samples share a row, attention stays within each segment, RoPE restarts
    per segment and the CE shift is masked at segment boundaries.
    ``pixel_values`` then carries all the packed images in token-stream
    order (``scatter_image_embeds`` consumes them so); the dense prompt
    needs one image per row and is not available."""
    if segment_ids is not None and output_dense_prompt:
        raise ValueError("fusion_forward: the dense prompt needs one image "
                         "per row; it is not available for packed rows")
    vit_tokens, sam_feats = extract_feature(
        model, cfg, pixel_values, stop_vision_gradient=stop_vision_gradient,
        remat=remat)
    lm = model.fusion.language_model
    embeds = scatter_image_embeds(input_ids, LLM.embed_tokens(lm, input_ids),
                                  vit_tokens, cfg.img_context_token_id)
    out = LLM.internlm2_forward(
        lm, cfg.llm, inputs_embeds=embeds, attention_mask=attention_mask,
        segment_ids=segment_ids,
        remat=remat if remat_llm is None else remat_llm)
    result = {"logits": out["logits"], "image_embeddings": sam_feats}
    if labels is not None:
        logits = out["logits"][:, :-1].float()
        targets = labels[:, 1:]
        valid = targets != -100
        if segment_ids is not None:  # never predict across a boundary
            valid &= segment_ids[:, :-1] == segment_ids[:, 1:]
        safe = torch.where(valid, targets, 0).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        # over data-parallel ranks: the global count's share
        denom = global_denominator(valid.sum(),
                                   getattr(model, "mesh", None))
        result["loss"] = torch.where(valid, nll, 0.0).sum() / denom
    if output_dense_prompt:
        image_hidden = gather_image_hidden(
            input_ids, out["last_hidden"], cfg.img_context_token_id,
            cfg.num_image_token)
        result["dense_prompt"] = text_aware_dense_feature(model, cfg,
                                                          image_hidden)
    return result


def segment_with_prompts(model: ULLSAM, cfg: FusionConfig,
                         sam_features: Tensor,
                         dense_prompt: Optional[Tensor],
                         point_coords: Tensor, point_labels: Tensor,
                         multimask_output: bool = False
                         ) -> Tuple[Tensor, Tensor]:
    """SAM decode with the LLM-conditioned dense prompt.

    sam_features, dense_prompt [1, 64, 64, 256] (dense_prompt None for the
    baseline no-mask prompt); point_coords [B, P, 2], point_labels [B, P].
    Returns (low-res logits [B, M, 256, 256], iou [B, M])."""
    pe = model.prompt_encoder
    B = point_coords.shape[0]
    sparse, dense = pe(points=(point_coords, point_labels))
    if dense_prompt is not None:
        llm_dense = pe.embed_llm_hidden(dense_prompt)
        dense = llm_dense.expand((B,) + tuple(llm_dense.shape[1:]))
    image_pe = pe.get_dense_pe()
    dt = sam_features.dtype
    return model.mask_decoder(sam_features, image_pe.to(dt), sparse.to(dt),
                              dense.to(dt), multimask_output=multimask_output)
