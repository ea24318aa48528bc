"""Segmentation losses (``ullsam_tpu/train/losses.py``): BCE-with-logits,
Dice, binary IoU, their masked mean over padded instances, and the fused
upsample + loss of the train step.

Instances come padded with a validity mask [B, I] (1 = real instance)
instead of Python-batched. The Hungarian-matched loss waits for an
on-device assignment (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullsam_tpu_torch.ops.resize import _bilinear_matrix

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
                  valid: Optional[Tensor]) -> Tuple[Tensor, dict]:
    valid = (torch.ones_like(bce) if valid is None
             else valid.to(bce.device).float())
    denom = valid.sum().clamp_min(1.0)
    bce_m, dice_m, iou_m = ((t * valid).sum() / denom
                            for t in (bce, dice, iou))
    total = bce_m + dice_m  # equal weights
    return total, {"bce": bce_m, "dice": dice_m, "iou": iou_m.detach(),
                   "seg_loss": total}


def instance_seg_loss(pred_logits: Tensor, gt_masks: Tensor,
                      valid: Optional[Tensor] = None) -> Tuple[Tensor, dict]:
    """Masked-mean BCE + Dice over instances: pred_logits, gt_masks
    [B, I, H, W]; valid [B, I]. Returns (total, {bce, dice, iou,
    seg_loss})."""
    return _masked_means(bce_with_logits(pred_logits, gt_masks),
                         dice_loss(pred_logits, gt_masks),
                         binary_iou(pred_logits, gt_masks), valid)


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
                                smooth: float = 1e-7) -> Tuple[Tensor, dict]:
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
    return _masked_means(bce, dice, iou, valid)
