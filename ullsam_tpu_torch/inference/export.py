"""The prompt decoder in serialized form (``ullsam_tpu/inference/export.py``;
the reference's ``SamOnnxModel``, utils/onnx.py:17-144).

- ``make_onnx_decoder_fn``: ``SamOnnxModel.forward`` as a function of the
  port's ``Sam`` (branchless point embedding, the ``has_mask_input`` lerp,
  optional stability scores, score-reweighted best-mask selection, the
  original-size postprocess);
- ``make_decoder_fn``: the minimal point decoder (low-res logits, IoU);
- ``export_decoder``: either one traced by ``torch.export.export`` and
  written by ``torch.export.save`` into bytes, the weights inside, so the
  artifact runs without the model code; ``load_exported_decoder`` loads it
  back as a callable.

The original size is fixed in an artifact (``orig_im_size``), or, with
``dynamic_size``, carried by the shape of a witness input [oh, ow] whose
two dimensions are exported as dynamic: one artifact serves every size.
The decoder is the plain one (``sam.decode_masks``), so an artifact holds
no custom kernel and runs wherever its tensors lie.
"""

from __future__ import annotations

import copy
import io
from typing import Optional, Tuple

import torch
from torch import nn

from ullsam_tpu_torch.core.config import SamConfig
from ullsam_tpu_torch.inference.amg import calculate_stability_score
from ullsam_tpu_torch.inference.transforms import get_preprocess_shape
from ullsam_tpu_torch.models.sam import sam as S
from ullsam_tpu_torch.ops.resize import (_bilinear_matrix, resize2d,
                                         sam_postprocess_resize)

Tensor = torch.Tensor

STABILITY_SCORE_OFFSET = 1.0  # onnx.py:38


def _embed_masks_lerp(sam, cfg: SamConfig, mask_input: Tensor,
                      has_mask_input: Tensor) -> Tensor:
    """Branchless dense prompt (onnx.py:69-74): the mask downscaler's output
    where ``has_mask_input`` [B] is 1, the no-mask embedding where it is 0.
    mask_input [B, 4H, 4W, 1] NHWC."""
    pe = sam.prompt_encoder
    down = pe.embed_masks(mask_input)
    no_mask = pe.no_mask_embed.weight.reshape(1, 1, 1, -1).to(down.dtype)
    w = has_mask_input.reshape(-1, 1, 1, 1).to(down.dtype)
    return w * down + (1.0 - w) * no_mask


def select_masks(masks: Tensor, iou_preds: Tensor, num_points: int
                 ) -> Tuple[Tensor, Tensor]:
    """Best mask without control flow (onnx.py:92-105): with more than one
    point the single-mask token 0 wins through a +1000 reweight, with one
    point the best multimask output."""
    nm = masks.shape[1]
    reweight = torch.zeros(nm, dtype=iou_preds.dtype,
                           device=iou_preds.device)
    reweight[0] = 1000.0
    score = iou_preds + (num_points - 2.5) * reweight[None, :]
    best = torch.argmax(score, dim=1)
    rows = torch.arange(masks.shape[0], device=masks.device)
    return masks[rows, best][:, None], iou_preds[rows, best][:, None]


def mask_postprocessing(masks: Tensor, img_size: int,
                        orig_im_size: Tuple[int, int]) -> Tensor:
    """Low-res logits to ``orig_im_size`` (onnx.py:76-90): bilinear to
    img_size, crop to the longest-side-resized extent, bilinear to the
    original size, as one pair of resize matmuls."""
    oh, ow = int(orig_im_size[0]), int(orig_im_size[1])
    prepadded = get_preprocess_shape(oh, ow, img_size)
    return sam_postprocess_resize(masks.float(), img_size, prepadded,
                                  (oh, ow))


def _bilinear_matrix_traced(out_dim, out_val: Tensor, in_size: int,
                            crop: Tensor) -> Tensor:
    """[out_dim, in_size] interpolation matrix drawing from the first
    ``crop`` input rows, ``out_dim`` possibly a dynamic dimension (its value
    also as the f32 scalar ``out_val``): the tent form max(0, 1 - |r - src|)
    gives the (1 - frac, frac) bilinear pair with edge clamping."""
    i = torch.arange(out_dim, dtype=torch.float32, device=crop.device)
    src = (i + 0.5) * (crop / out_val) - 0.5
    src = torch.minimum(src.clamp_min(0.0), crop - 1.0)
    r = torch.arange(in_size, dtype=torch.float32, device=crop.device)
    return (1.0 - (r[None, :] - src[:, None]).abs()).clamp_min(0.0)


def mask_postprocessing_dynamic(masks: Tensor, img_size: int,
                                witness: Tensor) -> Tensor:
    """``mask_postprocessing`` with the original size given by the shape of
    ``witness`` [oh, ow] (its values unused), built in the graph."""
    low_h, low_w = masks.shape[-2], masks.shape[-1]
    oh_f = torch.ones_like(witness[:, 0], dtype=torch.float32).sum()
    ow_f = torch.ones_like(witness[0], dtype=torch.float32).sum()
    long_side = torch.maximum(oh_f, ow_f)
    crop_h = torch.floor(img_size * oh_f / long_side + 0.5)
    crop_w = torch.floor(img_size * ow_f / long_side + 0.5)
    dev = masks.device
    mh = _bilinear_matrix_traced(witness.shape[0], oh_f, img_size, crop_h) \
        @ _bilinear_matrix(img_size, low_h, dev)
    mw = _bilinear_matrix_traced(witness.shape[1], ow_f, img_size, crop_w) \
        @ _bilinear_matrix(img_size, low_w, dev)
    return resize2d(masks, mh, mw)


def make_onnx_decoder_fn(cfg: SamConfig, *,
                         return_single_mask: bool = False,
                         use_stability_score: bool = False,
                         return_extra_metrics: bool = False,
                         orig_im_size: Optional[Tuple[int, int]] = None,
                         dynamic_size: bool = False):
    """``SamOnnxModel.forward`` (onnx.py:107-144) as ``fn(sam, embedding,
    point_coords, point_labels, mask_input, has_mask_input,
    size_witness=None)``:
      embedding      [1, H, W, C]   NHWC image embedding
      point_coords   [B, N, 2]      (x, y) in the model input frame, the
                                    caller's (0, 0) / -1 padding point
                                    included (ONNX convention)
      point_labels   [B, N]         {-1, 0, 1, 2, 3}
      mask_input     [B, 4H, 4W, 1] NHWC low-res mask logits
      has_mask_input [B]            float {0, 1}
    -> (upscaled masks, scores, low-res masks), or with
    ``return_extra_metrics`` (upscaled, scores, stability, areas, low-res).
    """
    img_size = cfg.vit.img_size
    size = orig_im_size if orig_im_size is not None else (img_size, img_size)
    thresh = cfg.mask_threshold

    def fn(sam, embedding, point_coords, point_labels, mask_input,
           has_mask_input, size_witness=None):
        pe = sam.prompt_encoder
        sparse = pe.embed_points(point_coords, point_labels)
        dense = _embed_masks_lerp(sam, cfg, mask_input, has_mask_input)
        masks, scores = sam.mask_decoder.predict_masks(
            embedding, pe.get_dense_pe(), sparse, dense)
        if use_stability_score:
            scores = calculate_stability_score(masks, thresh,
                                               STABILITY_SCORE_OFFSET)
        if return_single_mask:
            masks, scores = select_masks(masks, scores,
                                         point_coords.shape[1])
        if dynamic_size:
            upscaled = mask_postprocessing_dynamic(masks, img_size,
                                                   size_witness)
        else:
            upscaled = mask_postprocessing(masks, img_size, size)
        if return_extra_metrics:
            stability = calculate_stability_score(upscaled, thresh,
                                                  STABILITY_SCORE_OFFSET)
            areas = (upscaled > thresh).sum((-2, -1))
            return upscaled, scores, stability, areas, masks
        return upscaled, scores, masks

    return fn


def make_decoder_fn(cfg: SamConfig, multimask_output: bool = True):
    """The minimal point decoder: ``fn(sam, embedding [1, H, W, C], coords
    [B, N, 2], labels [B, N])`` -> (low-res logits [B, M, 4H, 4W], iou
    [B, M])."""

    def fn(sam, embedding, coords, labels):
        return S.decode_masks(sam.prompt_encoder, sam.mask_decoder,
                              embedding, points=(coords, labels),
                              multimask_output=multimask_output)

    return fn


class _Exported(nn.Module):
    """The prompt side of a ``Sam`` with a decoder function closed over it:
    what ``torch.export`` traces."""

    def __init__(self, sam, fn):
        super().__init__()
        self.prompt_encoder = copy.deepcopy(sam.prompt_encoder).float()
        self.mask_decoder = copy.deepcopy(sam.mask_decoder).float()
        self.fn = fn

    def forward(self, *args):
        return self.fn(self, *args)


def export_decoder(sam, cfg: SamConfig, num_points: int = 4, batch: int = 1,
                   *, full: bool = False, multimask_output: bool = True,
                   return_single_mask: bool = False,
                   use_stability_score: bool = False,
                   return_extra_metrics: bool = False,
                   orig_im_size: Optional[Tuple[int, int]] = None,
                   dynamic_size: bool = False) -> bytes:
    """The prompt decoder as a ``torch.export`` artifact (bytes), traced on
    the ``Sam``'s device and in float32. ``full=True`` exports the
    ``SamOnnxModel`` signature (mask input, postprocess); otherwise the
    minimal low-res point decoder."""
    dev = next(sam.parameters()).device
    h, w = cfg.prompt_encoder.image_embedding_size
    d = cfg.vit.out_chans
    emb = torch.zeros((1, h, w, d), device=dev)
    coords = torch.zeros((batch, num_points, 2), device=dev)
    labels = torch.ones((batch, num_points), dtype=torch.int64, device=dev)
    dynamic_shapes = None
    if full:
        fn = make_onnx_decoder_fn(
            cfg, return_single_mask=return_single_mask,
            use_stability_score=use_stability_score,
            return_extra_metrics=return_extra_metrics,
            orig_im_size=orig_im_size, dynamic_size=dynamic_size)
        args = (emb, coords, labels,
                torch.zeros((batch, 4 * h, 4 * w, 1), device=dev),
                torch.zeros((batch,), device=dev))
        if dynamic_size:
            # the witness's two dimensions are the runtime original size
            Dim = torch.export.Dim
            args += (torch.zeros((cfg.vit.img_size // 2 + 3,
                                  cfg.vit.img_size // 2 + 5), device=dev),)
            dynamic_shapes = ((None,) * 5
                              + ({0: Dim("oh", min=2), 1: Dim("ow", min=2)},),)
    else:
        fn = make_decoder_fn(cfg, multimask_output)
        args = (emb, coords, labels)
    module = _Exported(sam, fn).eval()
    with torch.no_grad():
        program = torch.export.export(module, args,
                                      dynamic_shapes=dynamic_shapes)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported_decoder(blob: bytes):
    """The callable of an ``export_decoder`` artifact, with the exported
    signature (an inference module: its weights take no gradient)."""
    module = torch.export.load(io.BytesIO(bytes(blob))).module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module
