"""The interactive-segmentation request and caption generation over the
fusion model (``ullsam_tpu/models/ullsam/chat.py``).

``segment_prefill`` runs the fused forward once and returns the LLM dense
prompt and the SAM features; ``point_segment`` decodes a mask from clicks
against them (decode, bilinear resize to the model size, sigmoid > 0.5).
``caption_ids`` is ``batch_chat`` from the moment its prompts are tokenized
and left-padded (``left_pad`` pads rows of ids to a bucket multiple): image
embeddings scattered into the token embeddings, then ``generate`` over the
KV cache. The entry points that take a tokenizer (``segment_forward``,
``chat``, ``batch_chat``, ``stream_chat``, ``chat.py:75-200``) build the
template's prompt and take any object with the ``data/tokenizer.py``
interface. Inputs may be numpy arrays or tensors; they move to the model's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.core.config import FusionConfig
from ullsam_tpu_torch.models.internlm2 import model as LLM
from ullsam_tpu_torch.models.internlm2.generate import (GenerationConfig,
                                                        generate,
                                                        sample_token)
from ullsam_tpu_torch.models.ullsam import fusion as F
from ullsam_tpu_torch.models.ullsam.conversation import (build_chat_prompt,
                                                         get_conv_template)
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
                step_hook: Optional[Callable[[int, Tensor], None]] = None,
                cache_dtype: Optional[torch.dtype] = None
                ) -> Tuple[Tensor, Tensor]:
    """Generate from left-padded prompts: pixel_values [1, S, S, 3] or None,
    input_ids and attention_mask [B, N] (``left_pad``). Returns (tokens
    [B, max_new_tokens] int32, lengths [B] int32) as ``generate`` does;
    ``gen`` carries the template's EOS and the pad id (default
    ``GenerationConfig()``); ``step_hook`` and ``cache_dtype`` go to
    ``generate``."""
    ids = _on(model, input_ids, torch.long)
    pixels = None if pixel_values is None else _on(model, pixel_values)
    embeds = embeds_with_image(model, cfg, ids, pixels)
    return generate(model.fusion.language_model, cfg.llm,
                    gen or GenerationConfig(), embeds,
                    _on(model, attention_mask, torch.int32),
                    generator=generator, step_hook=step_hook,
                    cache_dtype=cache_dtype)


def _chat_gen(cfg: FusionConfig, tokenizer,
              gen: Optional[GenerationConfig]) -> Tuple[GenerationConfig, str]:
    """``gen`` (default ``GenerationConfig()``) with the template
    separator's id as EOS and the tokenizer's pad id, and the separator."""
    sep = get_conv_template(cfg.template).sep.strip()
    gen = dataclasses.replace(gen or GenerationConfig(),
                              eos_token_id=tokenizer.convert_tokens_to_ids(sep),
                              pad_token_id=tokenizer.pad_token_id)
    return gen, sep


def chat(model: F.ULLSAM, cfg: FusionConfig, tokenizer, pixel_values,
         question: str, gen: Optional[GenerationConfig] = None,
         history: Optional[List[Tuple[str, str]]] = None,
         generator: Optional[torch.Generator] = None,
         return_history: bool = False):
    """Single-image chat (``chat.py:75-91``): the response string (and the
    history). pixel_values [1, S, S, 3] NHWC in [0, 1], or None for
    text-only chat."""
    responses, histories = batch_chat(model, cfg, tokenizer, pixel_values,
                                      [question], gen=gen,
                                      histories=[history or []],
                                      generator=generator)
    if return_history:
        return responses[0], histories[0]
    return responses[0]


def batch_chat(model: F.ULLSAM, cfg: FusionConfig, tokenizer, pixel_values,
               questions: List[str], gen: Optional[GenerationConfig] = None,
               histories: Optional[List[List[Tuple[str, str]]]] = None,
               generator: Optional[torch.Generator] = None):
    """Batched chat (``chat.py:94-128``): the template's prompts, left-padded
    by ``left_pad``, through ``caption_ids``; each response is decoded up to
    its EOS and cut at the separator. Returns (responses, histories)."""
    gen, sep = _chat_gen(cfg, tokenizer, gen)
    histories = histories or [[] for _ in questions]
    rows = [tokenizer.encode(build_chat_prompt(
        cfg.template, q, history=h, num_image_token=cfg.num_image_token,
        has_image=pixel_values is not None))
        for q, h in zip(questions, histories)]
    ids, mask = left_pad(rows, tokenizer.pad_token_id)
    tokens, lengths = caption_ids(model, cfg, pixel_values, ids, mask, gen,
                                  generator=generator)
    tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
    responses = []
    for b in range(tokens.shape[0]):
        text = tokenizer.decode(tokens[b, :lengths[b]].tolist())
        responses.append(text.split(sep)[0].strip())
        histories[b].append((questions[b], responses[-1]))
    return responses, histories


@torch.inference_mode()
def stream_chat(model: F.ULLSAM, cfg: FusionConfig, tokenizer, pixel_values,
                question: str, gen: Optional[GenerationConfig] = None,
                history: Optional[List[Tuple[str, str]]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Iterator[str]:
    """Token-streaming chat (``chat.py:131-185``; the reference's
    stream_chat, modeling_internlm2.py:1230-1292): yields text deltas, one
    decode step a token. A delta is yielded once the text cut at the
    separator has grown and does not end in U+FFFD (a partial byte
    sequence). For throughput, serve through ``serve.engine``."""
    gen, sep = _chat_gen(cfg, tokenizer, gen)
    lm = model.fusion.language_model
    prompt = build_chat_prompt(cfg.template, question, history=history,
                               num_image_token=cfg.num_image_token,
                               has_image=pixel_values is not None)
    ids = tokenizer.encode(prompt)
    input_ids = _on(model, [ids], torch.long)
    pixels = None if pixel_values is None else _on(model, pixel_values)
    embeds = embeds_with_image(model, cfg, input_ids, pixels)
    cache = LLM.init_cache(cfg.llm, 1, len(ids) + gen.max_new_tokens,
                           dtype=embeds.dtype, device=embeds.device)
    out, cache = LLM.internlm2_prefill(lm, cfg.llm, embeds,
                                       torch.ones_like(input_ids), cache)
    tok = int(sample_token(out["logits"][:, -1], gen, generator)[0])
    toks, emitted = [tok], ""
    for _ in range(gen.max_new_tokens - 1):
        if tok == gen.eos_token_id:
            break
        text = tokenizer.decode(toks).split(sep)[0]
        if len(text) > len(emitted) and not text.endswith("\ufffd"):
            yield text[len(emitted):]
            emitted = text
        emb = LLM.embed_tokens(lm, _on(model, [tok], torch.long))[:, None]
        logits, cache = LLM.internlm2_decode_step(lm, cfg.llm,
                                                  emb.to(embeds.dtype), cache)
        tok = int(sample_token(logits, gen, generator)[0])
        toks.append(tok)
    text = tokenizer.decode(toks).split(sep)[0]
    if len(text) > len(emitted):
        yield text[len(emitted):]


def segment_forward(model: F.ULLSAM, cfg: FusionConfig, tokenizer,
                    pixel_values,
                    question: str = "Describe the image in detail."
                    ) -> Tuple[Tensor, Tensor]:
    """The app's interactive-segmentation prefill (``chat.py:188-200``,
    app.py:549-598): one fused forward of the template's prompt with the
    fixed question, returning (dense_prompt, sam_features) for
    ``point_segment``."""
    prompt = build_chat_prompt(cfg.template, question,
                               num_image_token=cfg.num_image_token)
    return segment_prefill(model, cfg, pixel_values,
                           [tokenizer.encode(prompt)])
