"""Metrics and observability (``ullsam_tpu/train/metrics.py``): metric
writers, step timing, the boundary-overlay image, a FLOP estimate and a
profiler trace.

Behavioral reference: the reference's rank-0 wandb logging of loss / IoU /
lr / memory / samples per second (train_joint_v2.py:1103-1122, 1206-1215).
Writers: JSONL always; TensorBoard (tensorboardX) and wandb when they
import. The metric names match the reference's so dashboards carry over.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricWriter:
    """Fan-out metric writer of the one training process (the JAX
    package's writes on process 0 only; the port trains in one process,
    ROADMAP A6)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        self.log_dir = log_dir
        self._tb = None
        self._wandb = None
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                pass

    def log_image(self, step: int, tag: str, image: np.ndarray,
                  caption: str = "") -> None:
        """One [H, W, 3] float image in [0, 1] (the reference logs
        segmentation boundary overlays every N steps,
        train_joint_v2.py:1125-1167): a PNG under <log_dir>/images/, plus
        TensorBoard / wandb when enabled."""
        img8 = np.clip(np.asarray(image, np.float32) * 255.0,
                       0, 255).astype(np.uint8)
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        safe_tag = tag.replace("/", "_")
        try:
            from PIL import Image
            Image.fromarray(img8).save(
                os.path.join(img_dir, f"{safe_tag}_{step:08d}.png"))
        except ImportError:
            np.save(os.path.join(img_dir, f"{safe_tag}_{step:08d}.npy"), img8)
        self._jsonl.write(json.dumps(
            {"step": step, "image": tag, "caption": caption}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_image(tag, img8, step, dataformats="HWC")
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Image(img8, caption=caption)},
                            step=step)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Wall-clock step timing, samples per second and model FLOP
    utilization. The caller ends a step with a host read of its loss (or
    ``torch.cuda.synchronize()``) before ``stop`` so the time is the
    device's too."""

    # dense bf16 tensor-core peak of an H100 SXM (data sheet)
    PEAK_FLOPS = 989e12

    def __init__(self, flops_per_step: Optional[float] = None):
        self.flops_per_step = flops_per_step
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, batch_size: int) -> Dict[str, float]:
        dt = time.perf_counter() - self._t0
        out = {"batch_time": dt, "samples_per_second": batch_size / dt}
        if self.flops_per_step:
            out["mfu"] = self.flops_per_step / dt / self.PEAK_FLOPS
        return out


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Mask boundary = mask XOR eroded(mask) (train_joint_v2.py:1141-1156)."""
    from scipy import ndimage

    return np.logical_xor(mask, ndimage.binary_erosion(mask))


def segmentation_overlay(image: np.ndarray, pred_mask: np.ndarray,
                         gt_mask: np.ndarray) -> np.ndarray:
    """Boundary overlay: the prediction's boundary red, the ground truth's
    green, over the min-max normalized input (train_joint_v2.py:1125-1160).
    image [H, W, 3] float; masks [H, W] bool. Returns [H, W, 3] in [0, 1]."""
    img = np.asarray(image, np.float32)
    img = (img - img.min()) / (img.max() - img.min() + 1e-5)
    vis = img.copy()
    vis[_boundary(np.asarray(pred_mask, bool))] = (1.0, 0.0, 0.0)
    vis[_boundary(np.asarray(gt_mask, bool))] = (0.0, 1.0, 0.0)
    return vis


def train_step_flops(n_params: int, tokens_per_batch: int) -> float:
    """6ND estimate for the transformer portion of a train step."""
    return 6.0 * n_params * tokens_per_batch


def profile_trace(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the CPU and the card
    (when there is one), written to ``log_dir`` for TensorBoard /
    Perfetto on exit."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
