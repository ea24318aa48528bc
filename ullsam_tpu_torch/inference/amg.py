"""Automatic mask generation (AMG), single crop: point-grid sweep -> IoU and
stability filter -> NMS -> masks at the image size.

The port's counterpart of ``ullsam_tpu/inference/amg.py`` for
``crop_n_layers=0``:
  * the host helpers (``MaskData``, point grids, ``box_iou``, ``nms``, RLE,
    crop boxes, ``remove_small_regions`` through scipy) are copied, because
    that module imports jax;
  * ``amg_device_sweep`` keeps everything on the device until one packed
    stats read: resize the raw image, encode it (B1, B2), make the
    decoder's shared image side once, decode the prompt chunks through B4
    (masks, IoU, stability and low-res boxes per candidate), filter, greedy NMS or top-k, gather the survivors, upscale
    and threshold them to the image size;
  * ``AutomaticMaskGenerator`` has ``generate``, ``generate_dense`` and
    ``generate_dense_batch``, with all three output modes.
Multi-crop sweeps (``crop_n_layers > 0``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.core.config import SamConfig
from ullsam_tpu_torch.inference.transforms import (ResizeLongestSide,
                                                   get_preprocess_shape)
from ullsam_tpu_torch.models.sam import sam as S
from ullsam_tpu_torch.ops.resize import (bilinear_resize_nhwc,
                                         sam_postprocess_matrix)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# MaskData: dict of parallel host arrays with filter / cat
# ---------------------------------------------------------------------------


class MaskData:
    def __init__(self, **kwargs):
        self._stats: Dict[str, Any] = dict(kwargs)

    def __getitem__(self, k):
        return self._stats[k]

    def __setitem__(self, k, v):
        self._stats[k] = v

    def __contains__(self, k):
        return k in self._stats

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        keep = np.asarray(keep)
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list):
                idx = np.flatnonzero(keep) if keep.dtype == bool else keep
                self._stats[k] = [v[i] for i in idx]
            else:
                raise TypeError(f"unsupported MaskData type {type(v)}")

    def cat(self, other: "MaskData"):
        for k, v in other.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = v
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + v
            else:
                raise TypeError(f"unsupported MaskData type {type(v)}")


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    points_x = np.tile(points_one_side[None, :], (n_per_side, 1))
    points_y = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([points_x, points_y], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def batch_iterator(batch_size: int, *args):
    if not args or any(len(a) != len(args[0]) for a in args):
        raise ValueError("batch_iterator needs arguments of one length")
    n_batches = len(args[0]) // batch_size + int(
        len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [a[b * batch_size:(b + 1) * batch_size] for a in args]


def box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes."""
    a1 = np.maximum(boxes1[:, 2] - boxes1[:, 0], 0) * np.maximum(
        boxes1[:, 3] - boxes1[:, 1], 0)
    a2 = np.maximum(boxes2[:, 2] - boxes2[:, 0], 0) * np.maximum(
        boxes2[:, 3] - boxes2[:, 1], 0)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None, :] - inter
    return inter / np.maximum(union, 1e-7)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float
        ) -> np.ndarray:
    """Greedy NMS -> kept indices."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores)
    iou = box_iou(boxes, boxes)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def mask_to_rle(masks: np.ndarray) -> List[Dict[str, Any]]:
    """[B, H, W] bool -> uncompressed RLEs (column-major runs, starting with
    a 0-run, as COCO)."""
    B, H, W = masks.shape
    flat = masks.transpose(0, 2, 1).reshape(B, -1)
    out = []
    for b in range(B):
        row = flat[b]
        change = np.flatnonzero(row[1:] != row[:-1]) + 1
        idx = np.concatenate([[0], change, [H * W]])
        counts = np.diff(idx).tolist()
        if row[0]:
            counts = [0] + counts
        out.append({"size": [H, W], "counts": counts})
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Uncompressed RLE -> [H, W] bool."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx:idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Uncompressed counts -> COCO compressed string (the pycocotools LEB128
    variant with delta coding)."""
    h, w = uncompressed_rle["size"]
    counts = uncompressed_rle["counts"]
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or
                        (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return {"size": [h, w], "counts": out.decode("ascii")}


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """Overlapping crop boxes per layer; layer 0 = the full image."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i)
                       for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i)
                       for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                                   min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + np.asarray([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return points + np.asarray([[x0, y0]], points.dtype)


def uncrop_masks(masks: np.ndarray, crop_box: List[int], orig_h: int,
                 orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad = ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1))
    return np.pad(masks, pad)


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str
                         ) -> Tuple[np.ndarray, bool]:
    """Remove small connected components (``islands``) or fill small holes
    (``holes``), 8-connected, through scipy.ndimage."""
    from scipy import ndimage
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', not {mode!r}")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    labels, n = ndimage.label(working, structure=np.ones((3, 3)))
    sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = np.isin(labels, small)
    if correct_holes:
        return mask | fill, True
    big = ~fill & (labels > 0)
    if not big.any():
        # keep the largest island if everything was small
        big = labels == int(np.argmax(sizes)) + 1
    return big, True


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def calculate_stability_score(mask_logits: Tensor, mask_threshold: float,
                              threshold_offset: float) -> Tensor:
    """IoU of the high- and low-threshold binarizations, [..., H, W] ->
    [...]."""
    x = mask_logits.float()
    hi = (x > mask_threshold + threshold_offset).sum((-2, -1))
    lo = (x > mask_threshold - threshold_offset).sum((-2, -1))
    return hi.float() / lo.clamp_min(1).float()


def batched_mask_to_box(masks: Tensor) -> Tensor:
    """Bool masks [..., H, W] -> xyxy boxes [..., 4] f32 with inclusive
    edges; zeros for an empty mask."""
    H, W = masks.shape[-2], masks.shape[-1]
    any_row, any_col = masks.any(-1), masks.any(-2)
    rows = torch.arange(H, device=masks.device)
    cols = torch.arange(W, device=masks.device)
    top = torch.where(any_row, rows, H).amin(-1)
    bottom = torch.where(any_row, rows, -1).amax(-1)
    left = torch.where(any_col, cols, W).amin(-1)
    right = torch.where(any_col, cols, -1).amax(-1)
    box = torch.stack([left, top, right, bottom], dim=-1)
    return torch.where(any_row.any(-1)[..., None], box, 0).float()


def _device_box_iou(boxes: Tensor) -> Tensor:
    """Pairwise IoU [N, N] of xyxy boxes."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp_min(0) * (
        boxes[:, 3] - boxes[:, 1]).clamp_min(0)
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp_min(1e-7)


def _device_nms_topk(boxes: Tensor, scores: Tensor, iou_threshold: float,
                     k: int) -> Tuple[Tensor, Tensor]:
    """Greedy NMS keeping at most k boxes, on the device with no host sync:
    k steps of argmax and suppress over the IoU matrix. Returns (indices
    [k], valid [k])."""
    iou = _device_box_iou(boxes.float())
    scores = scores.float().clone()
    ninf = torch.tensor(float("-inf"), device=scores.device)
    idx, valid = [], []
    for _ in range(k):
        i = torch.argmax(scores)
        ok = scores[i] > ninf
        suppress = torch.where(iou[i] > iou_threshold, ninf, 0.0)
        scores = torch.where(ok, scores + suppress, scores)
        scores = scores.index_fill(0, i.view(1), float("-inf"))
        idx.append(i)
        valid.append(ok)
    return torch.stack(idx), torch.stack(valid)


def _upscale_threshold(cfg: SamConfig, low_res: Tensor,
                       out_hw: Tuple[int, int],
                       input_hw: Tuple[int, int]) -> Tensor:
    """Selected low-res logits [K, h, w] -> bool masks at out_hw (the SAM
    postprocess: resize, crop the pad, resize), computed as the reference
    does in bf16: bf16 matrices and logits, f32 sums, the intermediate
    rounded to bf16."""
    bf = torch.bfloat16
    mh = sam_postprocess_matrix(low_res.shape[-2], cfg.vit.img_size,
                                input_hw[0], out_hw[0], low_res.device)
    mw = sam_postprocess_matrix(low_res.shape[-1], cfg.vit.img_size,
                                input_hw[1], out_hw[1], low_res.device)
    y = torch.matmul(mh.to(bf).float(), low_res.to(bf).float())
    y = torch.matmul(y.to(bf).float(), mw.to(bf).float().T)
    return y > cfg.mask_threshold


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def amg_device_sweep(sam, cfg: SamConfig, image: Tensor, points: Tensor, *,
                     points_per_batch: int, max_out: int,
                     pred_iou_thresh: float, stability_thresh: float,
                     stability_offset: float, box_nms_thresh: float,
                     input_hw: Tuple[int, int], out_hw: Tuple[int, int],
                     n_real: int) -> Dict[str, Tensor]:
    """One image through the whole sweep on ``sam``'s device and dtype.

    image: [1, h, w, 3] raw (uint8 or float 0-255) on the device; points
    [n, 2] input-frame pixels, n % points_per_batch == 0, the first n_real
    real. Returns masks [max_out, *out_hw] bool and per-mask indices,
    valid, iou, stability, boxes_low, areas, and all of them packed into
    one [max_out, 9] f32 tensor (``stats_packed``) for one host read."""
    dtype = next(sam.parameters()).dtype
    x = bilinear_resize_nhwc(image, input_hw[0], input_hw[1])
    emb = S.encode_image(sam.image_encoder, S.preprocess(x, cfg).to(dtype))
    H, W = emb.shape[1], emb.shape[2]
    shared = S.shared_image(sam.prompt_encoder, sam.mask_decoder, emb)
    labels = torch.ones((points_per_batch, 1), dtype=torch.int64,
                        device=points.device)
    masks, iou, stability, boxes = [], [], [], []
    for (pts,) in batch_iterator(points_per_batch, points):
        m, i, (s, b) = S.decode_masks_stats(
            sam.prompt_encoder, sam.mask_decoder, emb,
            points=(pts[:, None, :], labels), multimask_output=True,
            stability_offset=stability_offset,
            mask_threshold=cfg.mask_threshold, shared=shared)
        masks.append(m.to(torch.bfloat16))
        iou.append(i.float().reshape(-1))
        stability.append(s.reshape(-1))
        boxes.append(b.reshape(-1, 4))
    M = masks[0].shape[1]
    masks = torch.cat(masks).reshape(-1, 4 * H, 4 * W)  # candidate p*M + m
    iou, stability = torch.cat(iou), torch.cat(stability)
    boxes = torch.cat(boxes)

    keep = torch.arange(iou.shape[0], device=iou.device) < n_real * M
    if pred_iou_thresh > 0.0:
        keep &= iou > pred_iou_thresh
    if stability_thresh > 0.0:
        keep &= stability >= stability_thresh
    scores = torch.where(keep, iou, float("-inf"))
    if box_nms_thresh < 1.0:
        idx, valid = _device_nms_topk(boxes, scores, box_nms_thresh,
                                      max_out)
    else:
        top = torch.topk(scores, max_out)
        idx, valid = top.indices, top.values > float("-inf")

    out_masks = _upscale_threshold(cfg, masks[idx], out_hw, input_hw)
    out_masks &= valid[:, None, None]
    out = {"masks": out_masks, "indices": idx, "valid": valid,
           "iou": iou[idx], "stability": stability[idx],
           "boxes_low": boxes[idx], "areas": out_masks.sum((1, 2))}
    out["stats_packed"] = torch.cat(
        [out["indices"].float()[:, None], out["valid"].float()[:, None],
         out["iou"][:, None], out["stability"][:, None], out["boxes_low"],
         out["areas"].float()[:, None]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


class AutomaticMaskGenerator:
    """SAM AMG on the port's ``Sam`` (single crop), at the model's dtype
    and on its device."""

    def __init__(self, cfg: SamConfig, sam, points_per_side: int = 32,
                 points_per_batch: int = 256,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
                 min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask",
                 max_masks: Optional[int] = None):
        if crop_n_layers != 0:
            raise NotImplementedError(
                "crop_n_layers > 0 (multi-crop AMG) is not ported yet: "
                "ROADMAP.md, queue A, 'multi-crop AMG'")
        if output_mode not in ("binary_mask", "uncompressed_rle",
                               "coco_rle"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        self.cfg = cfg
        self.sam = sam.eval()
        self.device = next(sam.parameters()).device
        self.point_grid = build_point_grid(points_per_side)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.max_masks = max_masks
        self.transform = ResizeLongestSide(cfg.vit.img_size)

    @torch.no_grad()
    def _sweep(self, image: np.ndarray):
        """Start one image's device sweep; returns a handle for
        ``_collect``."""
        orig_size = tuple(image.shape[:2])
        input_hw = get_preprocess_shape(orig_size[0], orig_size[1],
                                        self.cfg.vit.img_size)
        points_for_image = self.point_grid * np.array(orig_size)[None, ::-1]
        in_pts = self.transform.apply_coords(points_for_image, orig_size)
        n = len(in_pts)
        n_pad = -n % self.points_per_batch
        if n_pad:
            in_pts = np.concatenate([in_pts, np.zeros((n_pad, 2), np.float32)])
        max_out = min(self.max_masks or 512, n * 3)
        out = amg_device_sweep(
            self.sam, self.cfg,
            torch.from_numpy(np.ascontiguousarray(image))[None].to(
                self.device),
            torch.from_numpy(in_pts).to(self.device),
            points_per_batch=self.points_per_batch, max_out=max_out,
            pred_iou_thresh=self.pred_iou_thresh,
            stability_thresh=self.stability_score_thresh,
            stability_offset=self.stability_score_offset,
            box_nms_thresh=self.box_nms_thresh, input_hw=input_hw,
            out_hw=orig_size, n_real=n)
        return out, orig_size, input_hw, max_out, points_for_image, n

    def _collect(self, handle) -> Tuple[MaskData, Tensor]:
        """One host read of the packed stats -> (MaskData of the valid
        masks, masks [max_out, H, W] bool on the device)."""
        out, orig_size, input_hw, max_out, points_for_image, n = handle
        sp = out["stats_packed"].cpu().numpy()
        lr = 4 * self.cfg.prompt_encoder.image_embedding_size[0]
        boxes = sp[:, 4:8] * (self.cfg.vit.img_size / lr)
        boxes[:, [0, 2]] *= orig_size[1] / input_hw[1]
        boxes[:, [1, 3]] *= orig_size[0] / input_hw[0]
        indices = sp[:, 0].astype(np.int64)
        points = np.repeat(points_for_image, 3, axis=0)[
            np.clip(indices, 0, n * 3 - 1)]
        crop_box = [0, 0, orig_size[1], orig_size[0]]
        data = MaskData(
            candidate=indices, iou_preds=sp[:, 2], stability=sp[:, 3],
            boxes=uncrop_boxes_xyxy(boxes, crop_box),
            points=uncrop_points(points.astype(np.float32), crop_box),
            areas=sp[:, 8].astype(np.int64), valid=sp[:, 1].astype(bool),
            crop_boxes=np.asarray([crop_box] * max_out, np.float32),
            mask_slot=np.arange(max_out))
        data.filter(data["valid"])
        if self.max_masks is not None and len(data["iou_preds"]) > \
                self.max_masks:
            data.filter(np.argsort(-data["iou_preds"])[:self.max_masks])
        return data, out["masks"]

    def generate_dense(self, image: np.ndarray) -> Tuple[Tensor, MaskData]:
        """(masks [K, H, W] bool on the device, MaskData): no RLE, no bulk
        host transfer, one small stats read."""
        data, masks = self._collect(self._sweep(image))
        return masks[torch.from_numpy(data["mask_slot"]).to(masks.device)], \
            data

    def generate_dense_batch(self, images) -> List[Tuple[Tensor, MaskData]]:
        """Every image's sweep is queued on the device before any stats are
        read. Returns [(masks on the device, MaskData)] per image."""
        handles = [self._sweep(image) for image in images]
        results = []
        for handle in handles:
            data, masks = self._collect(handle)
            slots = data["mask_slot"]
            if not np.array_equal(slots, np.arange(masks.shape[0])):
                masks = masks[torch.from_numpy(slots).to(masks.device)]
            results.append((masks, data))
        return results

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image [H, W, 3] uint8 -> mask records (the upstream AMG output
        contract), sorted by area."""
        data, masks = self._collect(self._sweep(image))
        masks_full = masks[torch.from_numpy(data["mask_slot"]).to(
            masks.device)].cpu().numpy()
        K = len(masks_full)
        if self.min_mask_region_area > 0 and K:
            changed = np.zeros(K, bool)
            for i in range(K):
                m, ch1 = remove_small_regions(
                    masks_full[i], self.min_mask_region_area, "holes")
                m, ch2 = remove_small_regions(
                    m, self.min_mask_region_area, "islands")
                masks_full[i] = m
                changed[i] = ch1 or ch2
            # cleanup can merge duplicates: NMS again, unchanged first
            boxes_clean = batched_mask_to_box(
                torch.from_numpy(masks_full)).numpy()
            keep = np.sort(nms(boxes_clean, (~changed).astype(np.float32),
                               self.box_nms_thresh))
            data.filter(keep)
            masks_full = masks_full[keep]
            K = len(keep)

        rles = mask_to_rle(masks_full) if K else []
        boxes = (batched_mask_to_box(torch.from_numpy(masks_full)).numpy()
                 if K else np.zeros((0, 4)))
        records = []
        for i in range(K):
            crop_box = data["crop_boxes"][i].astype(int).tolist()
            rle, box = rles[i], boxes[i]
            records.append({
                "segmentation": (masks_full[i]
                                 if self.output_mode == "binary_mask"
                                 else rle if self.output_mode ==
                                 "uncompressed_rle"
                                 else coco_encode_rle(rle)),
                "area": area_from_rle(rle),
                "bbox": [float(box[0]), float(box[1]),
                         float(box[2] - box[0]), float(box[3] - box[1])],
                "predicted_iou": float(data["iou_preds"][i]),
                "point_coords": [data["points"][i].tolist()],
                "stability_score": float(data["stability"][i]),
                "crop_box": [crop_box[0], crop_box[1],
                             crop_box[2] - crop_box[0],
                             crop_box[3] - crop_box[1]],
            })
        records.sort(key=lambda r: -r["area"])
        return records
