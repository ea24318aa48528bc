"""SamPredictor (``ullsam_tpu/inference/predictor.py``): set an image once,
decode many prompts.

``set_image`` resizes the longest side to the model's input size (on the
device, rounded back to the image's integer type as the host resize of the
JAX package does), normalizes, pads and encodes once (B1, B2 on a card);
``predict`` takes points, labels, a box and a low-res mask input in
original-image coordinates through ``sam.decode_masks`` (the plain
decoder, no kernel) and postprocesses to the original size. Everything
runs on the ``Sam``'s device and in its dtype; the outputs come back as
numpy arrays, as the JAX predictor's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.core.config import SamConfig
from ullsam_tpu_torch.inference.transforms import (ResizeLongestSide,
                                                   get_preprocess_shape)
from ullsam_tpu_torch.models.sam import sam as S
from ullsam_tpu_torch.ops.resize import bilinear_resize_nhwc

Tensor = torch.Tensor


class SamPredictor:
    def __init__(self, cfg: SamConfig, sam):
        self.cfg = cfg
        self.sam = sam.eval()
        self.device = next(sam.parameters()).device
        self.dtype = next(sam.parameters()).dtype
        self.transform = ResizeLongestSide(cfg.vit.img_size)
        self.reset_image()

    def reset_image(self):
        self.is_image_set = False
        self.features = None
        self.original_size = None
        self.input_size = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray, image_format: str = "RGB"):
        """image: [H, W, 3] uint8 (or float 0-255). Resizes the longest
        side, normalizes, pads and runs the encoder once."""
        if image_format == "BGR":
            image = image[..., ::-1]
        self.original_size = tuple(image.shape[:2])
        self.input_size = get_preprocess_shape(*self.original_size,
                                               self.cfg.vit.img_size)
        x = torch.from_numpy(np.ascontiguousarray(image))[None].to(
            self.device)
        if self.input_size != self.original_size:
            resized = bilinear_resize_nhwc(x, *self.input_size)
            if not torch.is_floating_point(x):
                resized = resized.round().clamp(0, 255)
            x = resized
        x = S.preprocess(x.float(), self.cfg).to(self.dtype)
        self.features = S.encode_image(self.sam.image_encoder, x)
        self.is_image_set = True

    def set_image_embedding(self, features: Tensor,
                            original_size: Tuple[int, int],
                            input_size: Optional[Tuple[int, int]] = None):
        """Install precomputed [1, g, g, C] features (NHWC)."""
        self.features = torch.as_tensor(features).to(self.device,
                                                     self.dtype)
        self.original_size = tuple(original_size)
        self.input_size = tuple(input_size or (self.cfg.vit.img_size,
                                               self.cfg.vit.img_size))
        self.is_image_set = True

    @torch.no_grad()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True,
                return_logits: bool = False):
        """Prompts in original-image coordinates -> (masks [B, M, H, W],
        iou_predictions [B, M], low_res_logits [B, M, 4g, 4g]) as numpy.
        Each prompt kind left None is absent from the prompt, as in the
        reference's None checks."""
        if not self.is_image_set:
            raise RuntimeError("call set_image first")
        dev = self.device
        points = None
        if point_coords is not None:
            pc = self.transform.apply_coords(
                np.atleast_2d(point_coords).reshape(-1, 2)[None],
                self.original_size)
            pl = np.asarray(point_labels).reshape(1, -1)
            points = (torch.from_numpy(pc).to(dev),
                      torch.from_numpy(pl.astype(np.int64)).to(dev))
        boxes = None
        if box is not None:
            bx = self.transform.apply_coords(
                np.asarray(box).reshape(-1, 2, 2),
                self.original_size).reshape(-1, 4)
            boxes = torch.from_numpy(bx).to(dev)
        mi = None
        if mask_input is not None:
            mi = torch.tensor(np.asarray(mask_input, np.float32))
            if mi.ndim == 3:
                mi = mi[None]
            mi = mi.permute(0, 2, 3, 1).to(dev, self.dtype)  # NCHW -> NHWC
        low_res, iou = S.decode_masks(
            self.sam.prompt_encoder, self.sam.mask_decoder, self.features,
            points=points, boxes=boxes, mask_inputs=mi,
            multimask_output=multimask_output)
        masks = S.postprocess_masks(low_res, self.input_size,
                                    self.original_size, self.cfg)
        if not return_logits:
            masks = masks > self.cfg.mask_threshold
        return (masks.cpu().numpy(), iou.float().cpu().numpy(),
                low_res.float().cpu().numpy())

    def get_image_embedding(self) -> Tensor:
        if not self.is_image_set:
            raise RuntimeError("call set_image first")
        return self.features
