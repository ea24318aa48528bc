"""Segmentation losses (``ullsam_tpu/train/losses.py``): BCE-with-logits,
Dice, binary IoU, their masked mean over padded instances, the fused
upsample + loss of the train step, and the Hungarian-matched instance
loss.

Instances come padded with a validity mask [B, I] (1 = real instance)
instead of Python-batched. Under data parallelism (a ``mesh`` with a data
group) each rank divides its sums by its share of the whole batch's valid
count (``distributed.global_denominator``), so the mean over the ranks is
the whole batch's loss, as the JAX package's global mean is
(``losses.py:211-212, 237-238``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.ops.resize import _bilinear_matrix
from ullsam_tpu_torch.parallel.distributed import global_denominator

Tensor = torch.Tensor


def bce_with_logits(logits: Tensor, targets: Tensor) -> Tensor:
    """Per-instance mean BCE: [..., H, W] -> [...] (f32, stable form
    max(x, 0) - x y + log(1 + exp(-|x|)))."""
    x, y = logits.float(), targets.float()
    per_px = x.clamp_min(0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return per_px.mean(dim=(-2, -1))


def dice_loss(logits: Tensor, targets: Tensor, smooth: float = 1e-7) -> Tensor:
    """Per-instance Dice loss on sigmoided logits: [..., H, W] -> [...]."""
    probs = torch.sigmoid(logits.float())
    y = targets.float()
    num = 2.0 * (probs * y).sum(dim=(-2, -1))
    den = probs.sum(dim=(-2, -1)) + y.sum(dim=(-2, -1))
    return 1.0 - (num + smooth) / (den + smooth)


def binary_iou(logits: Tensor, targets: Tensor, smooth: float = 1e-7) -> Tensor:
    """Per-instance IoU at sigmoid > 0.5 (no gradient)."""
    with torch.no_grad():
        preds = (torch.sigmoid(logits.float()) > 0.5).float()
        y = targets.float()
        inter = (preds * y).sum(dim=(-2, -1))
        union = preds.sum(dim=(-2, -1)) + y.sum(dim=(-2, -1)) - inter
        return (inter + smooth) / (union + smooth)


def _masked_means(bce: Tensor, dice: Tensor, iou: Tensor,
                  valid: Optional[Tensor], mesh=None) -> Tuple[Tensor, dict]:
    valid = (torch.ones_like(bce) if valid is None
             else valid.to(bce.device).float())
    denom = global_denominator(valid.sum(), mesh)
    bce_m, dice_m, iou_m = ((t * valid).sum() / denom
                            for t in (bce, dice, iou))
    total = bce_m + dice_m  # equal weights
    return total, {"bce": bce_m, "dice": dice_m, "iou": iou_m.detach(),
                   "seg_loss": total}


def instance_seg_loss(pred_logits: Tensor, gt_masks: Tensor,
                      valid: Optional[Tensor] = None,
                      mesh=None) -> Tuple[Tensor, dict]:
    """Masked-mean BCE + Dice over instances: pred_logits, gt_masks
    [B, I, H, W]; valid [B, I]. Returns (total, {bce, dice, iou,
    seg_loss})."""
    return _masked_means(bce_with_logits(pred_logits, gt_masks),
                         dice_loss(pred_logits, gt_masks),
                         binary_iou(pred_logits, gt_masks), valid, mesh)


def hungarian_algorithm(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment of an [n, m] cost matrix -> (rows, cols),
    min(n, m) pairs: a float32 numpy copy of optax 0.2.6's
    ``optax.assignment.hungarian_algorithm`` (Jonker-Volgenant after
    Scenic), step for step, so that ties (such as the equal costs of
    padding columns) resolve to the same pairs. For n > m the matrix is
    transposed and the pairs come back sorted by column, largest first,
    as optax's ``top_k`` gives them."""
    cost = np.asarray(cost, np.float32)
    if cost.shape[0] == 0 or cost.shape[1] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    transpose = cost.shape[0] > cost.shape[1]
    if transpose:
        cost = cost.T
    rows, cols = cost.shape
    u = np.zeros(rows + 2, np.float32)   # row potentials (1-based, + a sink)
    v = np.zeros(cols + 1, np.float32)   # column potentials
    parent = np.zeros(cols + 1, np.int64)  # column -> row (1-based)
    inf = np.float32(np.inf)
    for row in range(rows):
        parent[0] = row + 1
        path = np.zeros(cols, np.int64)
        used = np.zeros(cols + 1, bool)
        minv = np.full(cols, inf, np.float32)
        col = 0
        while parent[col] != 0:
            used[col] = True
            unused = ~used[1:]
            r = parent[col]
            cur = cost[r - 1, :] - u[r] - v[1:]
            cur = np.where(unused, cur, inf)
            better = cur < minv
            path = np.where(better, col, path)
            minv = np.where(better, cur, minv)
            col = int(np.argmin(np.where(unused, minv, inf))) + 1
            delta = np.min(minv, where=unused, initial=inf)
            np.add.at(u, np.where(used, parent, rows + 1), delta)
            v = np.where(used, v - delta, v)
            minv = np.where(unused, minv - delta, minv)
        while col != 0:
            new_col = path[col - 1]
            parent[col] = parent[new_col]
            col = new_col
    if rows == cols:
        assigned, idx = parent[1:] - 1, np.arange(rows)
    else:
        idx = np.argsort(-parent[1:], kind="stable")[:rows]
        assigned = parent[1:][idx] - 1
    return (idx, assigned) if transpose else (assigned, idx)


def hungarian_instance_loss(pred_logits: Tensor, gt_masks: Tensor,
                            gt_valid: Optional[Tensor] = None, mesh=None
                            ) -> Tuple[Tensor, dict]:
    """Hungarian-matched instance loss (``losses.py:47-105``; the
    reference's ``variable_instance_loss``, train_joint_v2.py:698-940).

    pred_logits [B, P, H, W]; gt_masks [B, G, H, W]; gt_valid [B, G] (1 =
    real instance; None = all real); P >= G. The soft-IoU cost
    1 - IoU(sigmoid(pred), gt) [B, P, G] is computed on the tensors'
    device without gradient, invalid columns costing exactly 1.0. The
    assignment runs on the host: one device-to-host copy of the cost a
    step, then ``hungarian_algorithm`` per image (what optax runs on the
    device in the JAX package; the reference used scipy). The predictions
    and ground truths are gathered by the pairs (``take_along_dim``) and
    go through ``instance_seg_loss`` with the pairs' validity; the
    gradient flows through the gathered predictions only."""
    B, P = pred_logits.shape[:2]
    G = gt_masks.shape[1]
    if P < G:
        raise ValueError(f"need preds >= gt slots, got P={P} < G={G}")
    dev = pred_logits.device
    gt_valid = (torch.ones((B, G), device=dev) if gt_valid is None
                else gt_valid.to(dev).float())
    with torch.no_grad():
        pf = torch.sigmoid(pred_logits.float()).reshape(B, P, -1)
        gf = gt_masks.to(dev).float().reshape(B, G, -1)
        inter = torch.einsum("bph,bgh->bpg", pf, gf)
        union = pf.sum(-1)[:, :, None] + gf.sum(-1)[:, None, :] - inter
        cost = 1.0 - inter / (union + 1e-7)
        cost = torch.where(gt_valid[:, None, :] > 0, cost, 1.0)
    pairs = [hungarian_algorithm(c) for c in cost.cpu().numpy()]
    i_idx = torch.as_tensor(np.stack([p[0] for p in pairs]), device=dev)
    j_idx = torch.as_tensor(np.stack([p[1] for p in pairs]), device=dev)
    matched_pred = torch.take_along_dim(pred_logits,
                                        i_idx[:, :, None, None], dim=1)
    matched_gt = torch.take_along_dim(gt_masks.to(dev),
                                      j_idx[:, :, None, None], dim=1)
    pair_valid = torch.take_along_dim(gt_valid, j_idx, dim=1)
    return instance_seg_loss(matched_pred, matched_gt, pair_valid, mesh)


def _upsample(low: Tensor, mh: Tensor, mw: Tensor) -> Tensor:
    up = torch.einsum("jw,...hw->...hj", mw, low)
    return torch.einsum("ih,...hj->...ij", mh, up)


class UpsampledSegSums(torch.autograd.Function):
    """Per-instance sums of the bilinear-upsampled logits up = mh low mw^T
    (``_upsampled_seg_sums``, losses.py:107-177): (softplus(up), up*gt,
    sigmoid(up), sigmoid(up)*gt, gt, 1[up>0]*gt, 1[up>0]) summed over the
    last two axes. Saves only low, gt, mh, mw and the low-resolution
    projection of gt: no full-resolution residual; the backward recomputes
    up in one pass. The linear BCE term is pulled to low resolution exactly
    (sum(up * gt) = sum(low * (mh^T gt mw)))."""

    @staticmethod
    def forward(ctx, low, gt, mh, mw):
        low, gt = low.float(), gt.float()
        up = _upsample(low, mh, mw)
        gt_low = torch.einsum("jw,...hj->...hw", mw,
                              torch.einsum("ih,...ij->...hj", mh, gt))
        sig = torch.sigmoid(up)
        hard = (up > 0.0).float()
        softplus = up.clamp_min(0.0) + torch.log1p(torch.exp(-up.abs()))
        red = (-2, -1)
        ctx.save_for_backward(low, gt, gt_low, mh, mw)
        return (softplus.sum(red), (low * gt_low).sum(red), sig.sum(red),
                (sig * gt).sum(red), gt.sum(red), (hard * gt).sum(red),
                hard.sum(red))

    @staticmethod
    def backward(ctx, a_sp, a_upgt, a_sig, a_siggt, *_):
        low, gt, gt_low, mh, mw = ctx.saved_tensors
        sig = torch.sigmoid(_upsample(low, mh, mw))
        dsig = sig * (1.0 - sig)
        g = (a_sp[..., None, None] * sig + a_sig[..., None, None] * dsig
             + a_siggt[..., None, None] * (dsig * gt))
        d_low = torch.einsum("jw,...hj->...hw", mw,
                             torch.einsum("ih,...ij->...hj", mh, g))
        d_low = d_low + a_upgt[..., None, None] * gt_low
        return d_low, None, None, None


def upsampled_instance_seg_loss(low_logits: Tensor, gt_masks: Tensor,
                                valid: Optional[Tensor] = None,
                                smooth: float = 1e-7,
                                mesh=None) -> Tuple[Tensor, dict]:
    """instance_seg_loss(bilinear_resize(low, H, W), gt), fused: the same
    BCE + Dice + IoU with no [.., H, W] residual kept for the backward.
    low_logits [B, I, h, w]; gt_masks [B, I, H, W]."""
    H, W = gt_masks.shape[-2:]
    h, w = low_logits.shape[-2:]
    dev = low_logits.device
    mh, mw = _bilinear_matrix(H, h, dev), _bilinear_matrix(W, w, dev)
    gt = gt_masks.to(dev).float()
    (s_sp, s_upgt, s_sig, s_siggt, s_gt, s_hardgt,
     s_hard) = UpsampledSegSums.apply(low_logits, gt, mh, mw)
    bce = (s_sp - s_upgt) / float(H * W)
    dice = 1.0 - (2.0 * s_siggt + smooth) / (s_sig + s_gt + smooth)
    iou = ((s_hardgt + smooth) / (s_hard + s_gt - s_hardgt + smooth)).detach()
    return _masked_means(bce, dice, iou, valid, mesh)
