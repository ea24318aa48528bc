"""Composed SAM (``ullsam_tpu/models/sam/sam.py``): preprocess, encode,
prompt + mask decode, postprocess."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ullsam_tpu_torch.core.config import SamConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
from ullsam_tpu_torch.models.sam.mask_decoder import MaskDecoder, SharedImage
from ullsam_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from ullsam_tpu_torch.ops.resize import sam_postprocess_resize

Tensor = torch.Tensor


class Sam(nn.Module):
    """``image_encoder``, ``prompt_encoder``, ``mask_decoder`` under the
    reference SAM checkpoint names; on the GPU unless ``device`` says
    otherwise."""

    def __init__(self, cfg: SamConfig, *, device="cuda", dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg.vit, **kw)
        self.prompt_encoder = PromptEncoder(cfg.prompt_encoder, **kw)
        self.mask_decoder = MaskDecoder(cfg.mask_decoder, **kw)


def preprocess(images: Tensor, cfg: SamConfig) -> Tensor:
    """[B, H, W, 3] (0-255) -> normalized, padded bottom/right to img_size."""
    mean = torch.tensor(cfg.pixel_mean, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=images.dtype,
                       device=images.device)
    x = (images - mean) / std
    size = cfg.vit.img_size
    return F.pad(x, (0, 0, 0, size - x.shape[2], 0, size - x.shape[1]))


def encode_image(image_encoder: ImageEncoder, images: Tensor) -> Tensor:
    """[B, S, S, 3] -> [B, g, g, out_chans] NHWC."""
    return image_encoder(images)


def decode_masks(prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder,
                 image_embedding: Tensor,
                 points: Optional[Tuple[Tensor, Tensor]] = None,
                 boxes: Optional[Tensor] = None,
                 mask_inputs: Optional[Tensor] = None,
                 llm_hidden: Optional[Tensor] = None,
                 multimask_output: bool = True) -> Tuple[Tensor, Tensor]:
    """Prompt-encode + mask-decode for one image embedding [1, g, g, C].
    Returns (low-res logits [B, M, 4g, 4g], iou [B, M])."""
    sparse, dense = prompt_encoder(points=points, boxes=boxes,
                                   masks=mask_inputs, llm_hidden=llm_hidden)
    if mask_inputs is None and llm_hidden is None:
        dense = dense[:1]  # shared no-mask prompt keeps batch 1
    image_pe = prompt_encoder.get_dense_pe()
    return mask_decoder(image_embedding, image_pe, sparse, dense,
                        multimask_output=multimask_output)


def postprocess_masks(masks: Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int],
                      cfg: SamConfig) -> Tensor:
    """Low-res logits -> original size (resize, crop the pad, resize)."""
    return sam_postprocess_resize(masks.float(), cfg.vit.img_size,
                                  input_size, original_size)


def shared_image(prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder,
                 image_embedding: Tensor) -> SharedImage:
    """The decoder kernels' view of one image embedding [1, g, g, C] with
    the no-mask dense prompt: made once per image, passed to every chunk's
    ``decode_masks_cols`` / ``decode_masks_stats``."""
    _, dense = prompt_encoder()
    return mask_decoder.shared_image(image_embedding,
                                     prompt_encoder.get_dense_pe(), dense)


def decode_masks_cols(prompt_encoder: PromptEncoder,
                      mask_decoder: MaskDecoder, image_embedding: Tensor,
                      points: Tuple[Tensor, Tensor],
                      multimask_output: bool = True,
                      shared: Optional[SharedImage] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Point prompts against one image embedding [1, g, g, C] with the
    shared no-mask dense prompt (``dense[:1]``; ``shared`` from
    ``shared_image`` if the caller made it): (low-res logits of the
    selected masks [B, M, 4g, 4g], iou [B, M]) through B5 + B7. The
    counterpart of the JAX ``decode_masks_cols``, in the spatial layout."""
    sparse, dense = prompt_encoder(points=points)
    return mask_decoder.predict_masks_cols(
        image_embedding, prompt_encoder.get_dense_pe(), sparse, dense[:1],
        multimask_output=multimask_output, shared=shared)


def decode_masks_stats(prompt_encoder: PromptEncoder,
                       mask_decoder: MaskDecoder, image_embedding: Tensor,
                       points: Tuple[Tensor, Tensor],
                       multimask_output: bool = True,
                       stability_offset: float = 1.0,
                       mask_threshold: float = 0.0,
                       shared: Optional[SharedImage] = None):
    """``decode_masks_cols`` through B4, plus (stability [B, M], low-res
    boxes [B, M, 4]) at ``mask_threshold`` / ``stability_offset``:
    (masks, iou, (stability, boxes))."""
    sparse, dense = prompt_encoder(points=points)
    return mask_decoder.predict_masks_cols_stats(
        image_embedding, prompt_encoder.get_dense_pe(), sparse, dense[:1],
        multimask_output=multimask_output, thr=mask_threshold,
        off=stability_offset, shared=shared)
