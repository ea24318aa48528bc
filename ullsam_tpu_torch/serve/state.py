"""Serving session state (``ullsam_tpu/serve/state.py``): image geometry,
click accumulation, instance store, TIFF export. Host side: numpy and PIL,
and the port's bilinear resize on the CPU.

Behavioral reference: app.py's gr.State workflow — pad-to-square + resize
1024 ingest (:163-249), click accumulation (:497-547), incrementing-uint16
instance store (:665-725), HSV overlay (:84-95, 728-785), un-resize +
un-pad uint16 TIFF export (:788-833).
"""

from __future__ import annotations

import colorsys
import dataclasses
import io
from typing import List, Optional, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.inference.transforms import (pad_to_square,
                                                   reverse_padding)
from ullsam_tpu_torch.ops.resize import bilinear_resize_nhwc


def ingest_image(image: np.ndarray, target: int = 1024):
    """uint8 [H, W, C] any dtype -> (model_input [1,T,T,3] float01,
    display uint8 [T,T,3], geometry). Mirrors app.py:163-249."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        img = ((img - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    orig_hw = img.shape[:2]
    padded, pad_info = pad_to_square(img)
    pad_size = padded.shape[0]
    if pad_size != target:
        resized = bilinear_resize_nhwc(torch.from_numpy(padded)[None],
                                       target, target)[0].numpy()
        resized = np.clip(np.round(resized), 0, 255).astype(np.uint8)
    else:
        resized = padded
    model_input = resized.astype(np.float32)[None] / 255.0  # app.py:242-249
    geometry = {"orig_hw": orig_hw, "pad_info": pad_info,
                "pad_size": pad_size, "target": target}
    return model_input, resized, geometry


def export_instance_mask(instances: np.ndarray, geometry) -> np.ndarray:
    """uint16 instance mask at model res -> original image frame
    (app.py:788-833: un-resize with NEAREST, un-pad)."""
    from PIL import Image

    pad_size = geometry["pad_size"]
    img = Image.fromarray(instances.astype(np.int32), mode="I")
    img = img.resize((pad_size, pad_size), Image.NEAREST)
    arr = np.asarray(img).astype(np.uint16)
    return reverse_padding(arr, geometry["pad_info"])


def instance_overlay(display: np.ndarray, instances: np.ndarray,
                     current_mask: Optional[np.ndarray] = None,
                     alpha: float = 0.5) -> np.ndarray:
    """HSV-colored instance overlay (app.py:84-95, 728-785)."""
    out = display.astype(np.float32).copy()
    ids = np.unique(instances)
    ids = ids[ids > 0]
    for i, inst in enumerate(ids):
        hue = (i * 0.15) % 1.0
        color = np.asarray(colorsys.hsv_to_rgb(hue, 0.9, 1.0)) * 255
        sel = instances == inst
        out[sel] = (1 - alpha) * out[sel] + alpha * color
    if current_mask is not None:
        color = np.asarray([255.0, 64.0, 64.0])
        sel = current_mask.astype(bool)
        out[sel] = (1 - alpha) * out[sel] + alpha * color
    return np.clip(out, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class Session:
    model_input: Optional[np.ndarray] = None     # [1, T, T, 3] float01
    display: Optional[np.ndarray] = None         # [T, T, 3] uint8
    geometry: Optional[dict] = None
    points: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    labels: List[int] = dataclasses.field(default_factory=list)
    dense_prompt: Optional[np.ndarray] = None    # cached LLM dense prompt
    sam_features: Optional[np.ndarray] = None
    current_mask: Optional[np.ndarray] = None    # [T, T] bool
    current_iou: float = 0.0
    instances: Optional[np.ndarray] = None       # [T, T] uint16
    next_instance_id: int = 1

    def set_image(self, image: np.ndarray, target: int = 1024):
        self.model_input, self.display, self.geometry = ingest_image(
            image, target)
        self.points, self.labels = [], []
        self.dense_prompt = None
        self.sam_features = None
        self.current_mask = None
        self.instances = np.zeros(self.display.shape[:2], np.uint16)
        self.next_instance_id = 1

    def add_point(self, x: float, y: float, label: int):
        self.points.append((float(x), float(y)))
        self.labels.append(int(label))

    def clear_points(self):
        self.points, self.labels = [], []
        self.current_mask = None

    def save_instance(self) -> int:
        """Commit the current mask with an incrementing uint16 id
        (app.py:665-725)."""
        if self.current_mask is None:
            raise ValueError("no current mask to save")
        inst_id = self.next_instance_id
        self.instances[self.current_mask.astype(bool)] = inst_id
        self.next_instance_id += 1
        self.current_mask = None
        self.points, self.labels = [], []
        return inst_id

    def reset_instances(self):
        self.instances[:] = 0
        self.next_instance_id = 1
        self.current_mask = None

    def export_tiff(self) -> bytes:
        """uint16 instance TIFF in the original image frame."""
        from PIL import Image

        arr = export_instance_mask(self.instances, self.geometry)
        img = Image.fromarray(arr.astype(np.uint16))
        buf = io.BytesIO()
        img.save(buf, format="TIFF")
        return buf.getvalue()
