"""The interactive-segmentation request and caption generation over the
fusion model (``ullsam_tpu/models/ullsam/chat.py:28-72,93-128,203-211``).

``segment_prefill`` runs the fused forward once and returns the LLM dense
prompt and the SAM features; ``point_segment`` decodes a mask from clicks
against them (decode, bilinear resize to the model size, sigmoid > 0.5).
``caption_ids`` is ``batch_chat`` from the moment its prompts are tokenized
and left-padded (``left_pad`` pads rows of ids to a bucket multiple): image
embeddings scattered into the token embeddings, then ``generate`` over the
KV cache. Token ids are given by the caller: the tokenizer-taking entry
points (``segment_forward``, ``chat``, ``batch_chat``, ``stream_chat``) wait
for the tokenizer asset. Inputs may be numpy arrays or tensors; they move
to the model's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.core.config import FusionConfig
from ullsam_tpu_torch.models.internlm2 import model as LLM
from ullsam_tpu_torch.models.internlm2.generate import (GenerationConfig,
                                                        generate)
from ullsam_tpu_torch.models.ullsam import fusion as F
from ullsam_tpu_torch.ops.resize import bilinear_resize

Tensor = torch.Tensor


def _on(model: torch.nn.Module, x, dtype=None) -> Tensor:
    device = next(model.parameters()).device
    return torch.as_tensor(x, device=device, dtype=dtype)


@torch.inference_mode()
def segment_prefill(model: F.ULLSAM, cfg: FusionConfig, pixel_values,
                    input_ids) -> Tuple[Tensor, Tensor]:
    """pixel_values [1, S, S, 3], input_ids [1, N] -> (dense_prompt,
    sam_features), both [1, 64, 64, 256] NHWC."""
    out = F.fusion_forward(model, cfg, _on(model, pixel_values),
                           _on(model, input_ids, torch.long),
                           output_dense_prompt=True)
    return out["dense_prompt"], out["image_embeddings"]


@torch.inference_mode()
def point_segment(model: F.ULLSAM, cfg: FusionConfig, sam_features: Tensor,
                  dense_prompt: Optional[Tensor], point_coords, point_labels,
                  threshold: float = 0.5) -> Tuple[Tensor, Tensor, Tensor]:
    """Mask from clicks: point_coords [B, P, 2] (x, y), point_labels [B, P].
    Returns (binary mask [B, 1, S, S], probabilities [B, 1, S, S] f32,
    iou [B, 1])."""
    low_res, iou = F.segment_with_prompts(
        model, cfg, sam_features, dense_prompt,
        _on(model, point_coords, torch.float32),
        _on(model, point_labels, torch.long), multimask_output=False)
    size = cfg.sam.vit.img_size
    probs = torch.sigmoid(bilinear_resize(low_res.float(), size, size))
    return probs > threshold, probs, iou


def left_pad(rows: Sequence[Sequence[int]], pad_token_id: int,
             bucket_multiple: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Token-id rows -> (input_ids, attention_mask) [B, S] int64, left-padded
    to S = the longest row rounded up to ``bucket_multiple``
    (``_tokenize_left_padded``, ``chat.py:32-39``)."""
    n = max(len(r) for r in rows)
    S = -(-n // bucket_multiple) * bucket_multiple
    ids = np.full((len(rows), S), pad_token_id, np.int64)
    mask = np.zeros((len(rows), S), np.int64)
    for b, r in enumerate(rows):
        if len(r):
            ids[b, S - len(r):] = r
            mask[b, S - len(r):] = 1
    return ids, mask


def embeds_with_image(model: F.ULLSAM, cfg: FusionConfig, input_ids: Tensor,
                      pixel_values: Optional[Tensor]) -> Tensor:
    """Token embeddings with the visual tokens scattered into the
    <IMG_CONTEXT> positions (``chat.py:42-50``); ``pixel_values`` None for
    text only. One image serves every row (the scatter wraps around)."""
    embeds = LLM.embed_tokens(model.fusion.language_model, input_ids)
    if pixel_values is not None:
        vit_tokens, _ = F.extract_feature(model, cfg, pixel_values)
        embeds = F.scatter_image_embeds(input_ids, embeds, vit_tokens,
                                        cfg.img_context_token_id)
    return embeds


@torch.inference_mode()
def caption_ids(model: F.ULLSAM, cfg: FusionConfig, pixel_values, input_ids,
                attention_mask, gen: Optional[GenerationConfig] = None,
                generator: Optional[torch.Generator] = None,
                step_hook: Optional[Callable[[int, Tensor], None]] = None
                ) -> Tuple[Tensor, Tensor]:
    """Generate from left-padded prompts: pixel_values [1, S, S, 3] or None,
    input_ids and attention_mask [B, N] (``left_pad``). Returns (tokens
    [B, max_new_tokens] int32, lengths [B] int32) as ``generate`` does;
    ``gen`` carries the template's EOS and the pad id (default
    ``GenerationConfig()``); ``step_hook`` goes to ``generate``."""
    ids = _on(model, input_ids, torch.long)
    pixels = None if pixel_values is None else _on(model, pixel_values)
    embeds = embeds_with_image(model, cfg, ids, pixels)
    return generate(model.fusion.language_model, cfg.llm,
                    gen or GenerationConfig(), embeds,
                    _on(model, attention_mask, torch.int32),
                    generator=generator, step_hook=step_hook)
