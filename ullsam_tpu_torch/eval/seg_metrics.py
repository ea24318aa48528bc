"""Segmentation evaluation metrics: the port's own copy of
``ullsam_tpu/eval/seg_metrics.py`` (numpy and scipy on the host; the IoU
matrix through the native host ops when they load).

The reference's docstrings point at eval scripts that were never committed
(eval_uLLSAM_seg.py, app.py:214). This implements the standard instance-
segmentation evaluation for microscopy: per-instance IoU/Dice via greedy
matching, mean AP over IoU thresholds 0.5:0.95 (CellPose/COCO style),
aggregate pixel metrics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ullsam_tpu_torch.native import host_ops


def instances_to_masks(label_map: np.ndarray) -> np.ndarray:
    """uint instance map [H, W] -> [N, H, W] bool (ids sorted, bg excluded)."""
    ids = np.unique(label_map)
    ids = ids[ids > 0]
    return np.stack([label_map == i for i in ids], axis=0) if len(ids) \
        else np.zeros((0,) + label_map.shape, bool)


def mask_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[N, H, W] x [M, H, W] -> [N, M] IoU, float32: the native version
    (exact counts divided in float32) when the library loads, else
    ``_mask_iou_numpy`` (float64 [N, H*W] copies, divided in float64 and
    cast); the two may differ by one float32 ulp."""
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)), np.float32)
    if host_ops.available():
        return host_ops.mask_iou_matrix(pred, gt)
    return _mask_iou_numpy(pred, gt)


def _mask_iou_numpy(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """``mask_iou_matrix`` in numpy (the plain reference)."""
    p = pred.reshape(len(pred), -1).astype(np.float64)
    g = gt.reshape(len(gt), -1).astype(np.float64)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0
                    ).astype(np.float32)


def greedy_match(iou: np.ndarray, threshold: float):
    """Greedy best-IoU matching -> (tp, fp, fn, matched ious)."""
    n, m = iou.shape
    used_gt = np.zeros(m, bool)
    matched = []
    order = np.argsort(-iou.max(axis=1)) if m else np.arange(n)
    for i in order:
        if m == 0:
            break
        j = int(np.argmax(np.where(used_gt, -1.0, iou[i])))
        if not used_gt[j] and iou[i, j] >= threshold:
            used_gt[j] = True
            matched.append(iou[i, j])
    tp = len(matched)
    return tp, n - tp, m - tp, matched


def hungarian_match(iou: np.ndarray, threshold: float):
    """Optimal (Hungarian) matching -> (tp, fp, fn, matched ious).

    The reference carries an (unused) Hungarian variable_instance_loss
    (train_joint_v2.py:698-940, dead code); this provides the optimal
    matcher for EVALUATION, where greedy matching can undercount TPs when
    one prediction overlaps several GTs. Uses scipy's
    linear_sum_assignment; falls back to greedy if scipy is absent."""
    n, m = iou.shape
    if n == 0 or m == 0:
        return 0, n, m, []
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:  # pragma: no cover
        return greedy_match(iou, threshold)
    # Zero sub-threshold entries first so the assignment maximizes the
    # COUNT of above-threshold matches (raw -iou maximizes total IoU,
    # which can trade two threshold-clearing matches for one big one).
    rows, cols = linear_sum_assignment(-np.where(iou >= threshold, iou, 0.0))
    matched = [iou[i, j] for i, j in zip(rows, cols)
               if iou[i, j] >= threshold]
    tp = len(matched)
    return tp, n - tp, m - tp, matched


def average_precision(pred: np.ndarray, gt: np.ndarray,
                      thresholds: Sequence[float] = tuple(
                          np.arange(0.5, 1.0, 0.05)),
                      matcher: str = "greedy") -> Dict[str, float]:
    """AP_t = tp / (tp + fp + fn) per threshold (CellPose convention).

    matcher: "greedy" (CellPose-style, default) or "hungarian" (optimal
    assignment)."""
    match_fn = hungarian_match if matcher == "hungarian" else greedy_match
    iou = mask_iou_matrix(pred, gt)
    out = {}
    aps = []
    all_matched = []
    for t in thresholds:
        tp, fp, fn, matched = match_fn(iou, t)
        ap = tp / max(tp + fp + fn, 1)
        aps.append(ap)
        if abs(t - 0.5) < 1e-6:
            out["ap50"] = ap
            all_matched = matched
    out["map"] = float(np.mean(aps))
    out["mean_matched_iou"] = float(np.mean(all_matched)) if all_matched else 0.0
    out["n_pred"] = len(pred)
    out["n_gt"] = len(gt)
    return out


def pixel_metrics(pred_fg: np.ndarray, gt_fg: np.ndarray) -> Dict[str, float]:
    """Binary foreground IoU / Dice / precision / recall."""
    p = pred_fg.astype(bool)
    g = gt_fg.astype(bool)
    inter = float(np.logical_and(p, g).sum())
    union = float(np.logical_or(p, g).sum())
    ps, gs = float(p.sum()), float(g.sum())
    return {
        "pixel_iou": inter / max(union, 1),
        "dice": 2 * inter / max(ps + gs, 1),
        "precision": inter / max(ps, 1),
        "recall": inter / max(gs, 1),
    }


def aggregate(results: List[Dict[str, float]]) -> Dict[str, float]:
    keys = set().union(*[set(r) for r in results]) if results else set()
    return {k: float(np.mean([r[k] for r in results if k in r]))
            for k in keys}
