"""Automatic mask generation (AMG): point-grid sweep -> IoU and stability
filter -> NMS -> masks at the image size, over one crop or a crop pyramid.

The port's counterpart of ``ullsam_tpu/inference/amg.py``:
  * the host helpers (``MaskData``, point grids, ``box_iou``, ``nms``, RLE,
    crop boxes, ``remove_small_regions`` through scipy) are copied, because
    that module imports jax; RLE takes the native host ops
    (``native/host_ops.py``) when they load, numpy otherwise;
  * ``amg_device_sweep`` keeps everything on the device until one packed
    stats read: resize the raw image, encode it (B1, B2), make the
    decoder's shared image side once, decode the prompt chunks through B4
    (masks, IoU, stability and low-res boxes per candidate), filter,
    greedy NMS or top-k, gather the survivors, upscale and threshold them
    to the image size;
  * ``amg_sharded_sweep`` sweeps one image a rank over a process group and
    gathers the results to rank 0;
  * with crops, each crop is its own ``amg_device_sweep`` of the uploaded
    image, and ``_merge_crops_device`` runs the cross-crop NMS and places
    the survivors into the full frame on the device;
  * ``AutomaticMaskGenerator`` has ``generate``, ``generate_dense`` and
    ``generate_dense_batch``, with all three output modes and crops
    (``crop_n_layers``), on the device or stitched on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.core.config import SamConfig
from ullsam_tpu_torch.inference.transforms import (ResizeLongestSide,
                                                   get_preprocess_shape)
from ullsam_tpu_torch.models.sam import sam as S
from ullsam_tpu_torch.native import host_ops
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
    a 0-run, as COCO): the native encoder when the library loads, else
    ``_mask_to_rle_numpy``."""
    if host_ops.available():
        return host_ops.mask_to_rle(masks)
    return _mask_to_rle_numpy(masks)


def _mask_to_rle_numpy(masks: np.ndarray) -> List[Dict[str, Any]]:
    """``mask_to_rle`` in numpy (the plain reference)."""
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
    (``holes``), 8-connected, labelled by scipy.ndimage (faster than the
    native ``connected_components`` on the H100 machine's CPU: PERF.md)."""
    from scipy import ndimage
    return _remove_small_regions(
        mask, area_thresh, mode,
        lambda w: ndimage.label(w, structure=np.ones((3, 3))))


def _remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str,
                          label) -> Tuple[np.ndarray, bool]:
    """``remove_small_regions`` with ``label`` (a uint8 [H, W] -> (int32
    labels, count) 8-connected labelling)."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', not {mode!r}")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    labels, n = label(working)
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
    """One image (or crop) through the whole sweep on ``sam``'s device and
    dtype.

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


def amg_sharded_sweep(sam, cfg: SamConfig, images, points, *,
                      points_per_batch: int = 256, max_out: int = 256,
                      pred_iou_thresh: float = 0.0,
                      stability_thresh: float = 0.0,
                      stability_score_offset: float = 1.0,
                      box_nms_thresh: float = 1.0,
                      input_hw: Optional[Tuple[int, int]] = None,
                      out_hw: Optional[Tuple[int, int]] = None
                      ) -> Optional[Dict[str, Tensor]]:
    """Image-parallel AMG (``amg.py:1309-1362``): one image a rank.

    images: [D, H, W, 3] raw (uint8 or float 0-255; host or device), D the
    world size of the default process group (1 without one); points
    [N, 2] the shared prompt grid in the input frame. Rank r sweeps
    images[r] alone through ``amg_device_sweep`` on ``sam``'s device, with
    no communication; then every result is gathered to rank 0, which
    returns the per-image dicts stacked on a leading [D] axis (the other
    ranks return None). Without a process group one process sweeps all D
    images in turn. Each image's masks are bitwise its own
    ``amg_device_sweep``'s."""
    from ullsam_tpu_torch.parallel import distributed as D

    dev = next(sam.parameters()).device
    n_img, H, W = images.shape[:3]
    world, rank = D.process_count(), D.process_index()
    if world > 1 and n_img != world:
        raise ValueError(f"amg_sharded_sweep: {n_img} images for {world} "
                         f"ranks; give one image a rank")
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n_real = pts.shape[0]
    n_pad = -n_real % points_per_batch
    if n_pad:
        pts = torch.cat([pts, pts.new_zeros((n_pad, 2))])
    img = cfg.vit.img_size
    kw = dict(points_per_batch=points_per_batch, max_out=max_out,
              pred_iou_thresh=pred_iou_thresh,
              stability_thresh=stability_thresh,
              stability_offset=stability_score_offset,
              box_nms_thresh=box_nms_thresh,
              input_hw=input_hw or (img, img), out_hw=out_hw or (H, W),
              n_real=n_real)
    mine = [rank] if world > 1 else range(n_img)
    outs = [amg_device_sweep(
        sam, cfg, torch.as_tensor(images[i:i + 1]).to(dev), pts, **kw)
        for i in mine]
    if world == 1:
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    stacked = {}
    for k, v in outs[0].items():     # the same keys in the same order
        parts = D.gather_to_main(v)
        if parts is not None:
            stacked[k] = torch.stack(parts)
    return stacked if rank == 0 else None


def _merge_crops_device(outs: Sequence[Dict[str, Tensor]], crop_boxes,
                        scales: Sequence[Tuple[float, float]],
                        orig_hw: Tuple[int, int], crop_nms_thresh: float,
                        final_k: int) -> Dict[str, Tensor]:
    """Cross-crop NMS and survivor placement on the device, with no host
    sync.

    outs: each crop's ``amg_device_sweep`` (masks [M, ch, cw]), the full
    image first; crop_boxes: their boxes [x0, y0, x1, y1] on the host;
    scales: each sweep's low-res box scale (sh, sw). Every candidate's box
    goes to the original frame, and all of them NMS together at
    ``crop_nms_thresh``, smaller crops preferred (score 1 / (crop area + 1)
    + 1e-9 * iou, in f32), keeping at most ``final_k``; each survivor's
    mask is taken from its crop's sweep and written at the crop's offset
    into a zeroed full-frame mask (slice assignment, one a crop)."""
    H, W = orig_hw
    dev = outs[0]["valid"].device
    f32 = torch.float32
    boxes, pref, crop_of, sizes = [], [], [], []
    for out, (x0, y0, x1, y1), (sh, sw) in zip(outs, crop_boxes, scales):
        M = out["valid"].shape[0]
        off = torch.tensor([x0, y0, x0, y0], dtype=f32, device=dev)
        boxes.append(out["boxes_low"] * torch.tensor(
            [sw, sh, sw, sh], dtype=f32, device=dev) + off)
        pref.append(torch.full((M,), 1.0 / (float(y1 - y0) * float(x1 - x0)
                                            + 1.0), dtype=f32, device=dev))
        crop_of.append(torch.tensor([x0, y0, x1, y1], dtype=f32,
                                    device=dev).expand(M, 4))
        sizes.append(M)
    boxes, pref, crop_of = torch.cat(boxes), torch.cat(pref), \
        torch.cat(crop_of)
    valid = torch.cat([o["valid"] for o in outs])
    iou = torch.cat([o["iou"] for o in outs])
    stab = torch.cat([o["stability"] for o in outs])
    scores = torch.where(valid, pref + 1e-9 * iou, float("-inf"))

    idx, keep = _device_nms_topk(boxes, scores, crop_nms_thresh, final_k)

    masks = torch.zeros((final_k, H, W), dtype=torch.bool, device=dev)
    start = 0
    for out, (x0, y0, x1, y1), M in zip(outs, crop_boxes, sizes):
        rel = idx - start
        mine = ((rel >= 0) & (rel < M))[:, None, None]
        masks[:, y0:y1, x0:x1] |= out["masks"][rel.clamp(0, M - 1)] & mine
        start += M
    masks &= keep[:, None, None]
    return {"masks": masks, "valid": keep, "iou": iou[idx],
            "stability": stab[idx], "boxes": boxes[idx],
            "crop_box_of": crop_of[idx], "areas": masks.sum((1, 2))}


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


class AutomaticMaskGenerator:
    """SAM AMG on the port's ``Sam``, at the model's dtype and on its
    device: the upstream generator contract, with crops.

    ``crop_n_layers`` > 0 adds the crop pyramid of ``generate_crop_boxes``
    (layer i: 2**i x 2**i crops overlapping by ``crop_overlap_ratio``, its
    point grid thinned by ``crop_n_points_downscale_factor`` ** i). With
    ``device_multicrop`` (the default) every crop sweeps on the device and
    one cross-crop NMS (``crop_nms_thresh``, smaller crops preferred)
    places the survivors into the full frame there; with it False every
    crop is collected on its own and stitched on the host, as upstream
    does."""

    def __init__(self, cfg: SamConfig, sam, points_per_side: int = 32,
                 points_per_batch: int = 256,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask",
                 max_masks: Optional[int] = None,
                 device_multicrop: bool = True):
        if crop_n_layers < 0:
            raise ValueError(f"crop_n_layers must be >= 0, not "
                             f"{crop_n_layers}")
        if output_mode not in ("binary_mask", "uncompressed_rle",
                               "coco_rle"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        self.cfg = cfg
        self.sam = sam.eval()
        self.device = next(sam.parameters()).device
        self.point_grids = build_all_layer_point_grids(
            points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.max_masks = max_masks
        self.device_multicrop = device_multicrop
        self.transform = ResizeLongestSide(cfg.vit.img_size)
        self._pts_cache: Dict[Tuple[int, Tuple[int, int]], tuple] = {}

    # -- per-crop sweep ---------------------------------------------------

    def _crop_points(self, layer_idx: int, crop_size: Tuple[int, int]):
        """(the layer's grid in crop pixels, the input-frame points padded
        to whole chunks on the device, the real count): made once for each
        (layer, crop size)."""
        key = (layer_idx, tuple(crop_size))
        if key not in self._pts_cache:
            points_for_image = (self.point_grids[layer_idx]
                                * np.array(crop_size)[None, ::-1])
            in_pts = self.transform.apply_coords(points_for_image, crop_size)
            n = len(in_pts)
            n_pad = -n % self.points_per_batch
            if n_pad:
                in_pts = np.concatenate([in_pts,
                                         np.zeros((n_pad, 2), np.float32)])
            self._pts_cache[key] = (points_for_image,
                                    torch.from_numpy(in_pts).to(self.device),
                                    n)
        return self._pts_cache[key]

    def _sweep_kw(self, n: int) -> dict:
        return dict(points_per_batch=self.points_per_batch,
                    max_out=min(self.max_masks or 512, n * 3),
                    pred_iou_thresh=self.pred_iou_thresh,
                    stability_thresh=self.stability_score_thresh,
                    stability_offset=self.stability_score_offset,
                    box_nms_thresh=self.box_nms_thresh, n_real=n)

    def _upload(self, images: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    @torch.no_grad()
    def _process_crop(self, image: Tensor, crop_box: List[int],
                      layer_idx: int, defer: bool = False):
        """One crop's device sweep of the uploaded image [H, W, 3]. With
        ``defer`` a handle for ``_collect_crop``, else its result."""
        x0, y0, x1, y1 = crop_box
        crop_size = (y1 - y0, x1 - x0)
        input_hw = get_preprocess_shape(crop_size[0], crop_size[1],
                                        self.cfg.vit.img_size)
        points_for_image, in_pts, n = self._crop_points(layer_idx, crop_size)
        kw = self._sweep_kw(n)
        out = amg_device_sweep(
            self.sam, self.cfg, image[None, y0:y1, x0:x1].contiguous(),
            in_pts, input_hw=input_hw, out_hw=crop_size, **kw)
        handle = (out, crop_box, crop_size, input_hw, kw["max_out"],
                  points_for_image, n)
        return handle if defer else self._collect_crop(*handle)

    def _collect_crop(self, out, crop_box, crop_size, input_hw, max_out,
                      points_for_image, n) -> Tuple[MaskData, Tensor, int]:
        """One host read of a crop's packed stats -> (MaskData of all
        max_out rows, masks [max_out, ch, cw] bool on the device,
        max_out)."""
        sp = out["stats_packed"].cpu().numpy()
        lr = 4 * self.cfg.prompt_encoder.image_embedding_size[0]
        boxes = sp[:, 4:8] * (self.cfg.vit.img_size / lr)
        boxes[:, [0, 2]] *= crop_size[1] / input_hw[1]
        boxes[:, [1, 3]] *= crop_size[0] / input_hw[0]
        indices = sp[:, 0].astype(np.int64)
        points = np.repeat(points_for_image, 3, axis=0)[
            np.clip(indices, 0, n * 3 - 1)]
        data = MaskData(
            candidate=indices, iou_preds=sp[:, 2], stability=sp[:, 3],
            boxes=uncrop_boxes_xyxy(boxes, crop_box),
            points=uncrop_points(points.astype(np.float32), crop_box),
            areas=sp[:, 8].astype(np.int64), valid=sp[:, 1].astype(bool),
            crop_boxes=np.asarray([crop_box] * max_out, np.float32),
            mask_slot=np.arange(max_out),
            crop_index=np.zeros(max_out, np.int64))
        return data, out["masks"], max_out

    # -- crops on the device ----------------------------------------------

    def _merge_scale(self, crop_hw, input_hw):
        lr = 4 * self.cfg.prompt_encoder.image_embedding_size[0]
        size = self.cfg.vit.img_size
        return (size / lr * crop_hw[0] / input_hw[0],
                size / lr * crop_hw[1] / input_hw[1])

    @torch.no_grad()
    def _collect_device_multicrop(self, image: Tensor, crop_boxes,
                                  layer_idxs, orig_size):
        """Any crop pyramid on the device: each crop (the full image first)
        swept by its own ``amg_device_sweep`` of the uploaded image, then
        one cross-crop NMS and placement; one host read, of the merge's
        stats -> the MaskData of the valid survivors (masks already in the
        full frame)."""
        outs, scales = [], []
        for box, li in zip(crop_boxes, layer_idxs):
            out, _, crop_size, input_hw, *_ = self._process_crop(
                image, box, li, defer=True)
            outs.append(out)
            scales.append(self._merge_scale(crop_size, input_hw))
        merged = _merge_crops_device(outs, crop_boxes, scales,
                                     tuple(orig_size), self.crop_nms_thresh,
                                     self.max_masks or 512)
        K = merged["valid"].shape[0]
        sp = torch.cat([merged["valid"].float()[:, None],
                        merged["iou"][:, None], merged["stability"][:, None],
                        merged["boxes"], merged["areas"].float()[:, None],
                        merged["crop_box_of"]], dim=-1).cpu().numpy()
        full_box = [0, 0, orig_size[1], orig_size[0]]
        data = MaskData(
            iou_preds=sp[:, 1], stability=sp[:, 2], boxes=sp[:, 3:7],
            points=np.zeros((K, 2), np.float32),
            areas=sp[:, 7].astype(np.int64), valid=sp[:, 0].astype(bool),
            # the masks are placed already: their crop box is the whole
            # image; the source crop is reported apart
            crop_boxes=np.asarray([full_box] * K, np.float32),
            report_crop_boxes=sp[:, 8:12], mask_slot=np.arange(K),
            crop_index=np.zeros(K, np.int64))
        data.filter(data["valid"])
        return data, [merged["masks"]], orig_size

    def _collect(self, image: np.ndarray):
        """Sweep every crop. Returns (MaskData of the valid survivors after
        the cross-crop NMS, each row with its crop_index and mask_slot; the
        device masks of each crop (one full-frame array on the device
        paths); the original size)."""
        orig_size = tuple(image.shape[:2])
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        image = self._upload(image)
        if self.device_multicrop and len(crop_boxes) > 1:
            return self._collect_device_multicrop(image, crop_boxes,
                                                  layer_idxs, orig_size)

        data, device_masks = None, []
        for ci, (crop_box, layer_idx) in enumerate(zip(crop_boxes,
                                                       layer_idxs)):
            cd, masks, max_out = self._process_crop(image, crop_box,
                                                    layer_idx)
            cd["crop_index"] = np.full(max_out, ci, np.int64)
            device_masks.append(masks)
            if data is None:
                data = cd
            else:
                data.cat(cd)
        data.filter(data["valid"])
        if len(crop_boxes) > 1 and len(data["boxes"]):
            # smaller crops first
            cb = data["crop_boxes"]
            areas = (cb[:, 2] - cb[:, 0]) * (cb[:, 3] - cb[:, 1])
            data.filter(nms(data["boxes"], (1.0 / (areas + 1.0)).astype(
                np.float32), self.crop_nms_thresh))
        if (self.max_masks is not None
                and len(data["iou_preds"]) > self.max_masks):
            data.filter(np.argsort(-data["iou_preds"])[:self.max_masks])
        return data, device_masks, orig_size

    def _masks_to_host(self, data: MaskData, device_masks, orig_size
                       ) -> np.ndarray:
        """The kept masks [K, H, W] bool on the host, each crop's uncropped
        into the full frame."""
        out = np.zeros((len(data["iou_preds"]), *orig_size), bool)
        for ci, masks in enumerate(device_masks):
            rows = np.flatnonzero(data["crop_index"] == ci)
            if not len(rows):
                continue
            sel = masks[torch.from_numpy(data["mask_slot"][rows]).to(
                masks.device)].cpu().numpy()
            crop_box = data["crop_boxes"][rows[0]].astype(int).tolist()
            out[rows] = uncrop_masks(sel, crop_box, *orig_size)
        return out

    def generate_dense(self, image: np.ndarray) -> Tuple[Tensor, MaskData]:
        """(masks [K, H, W] bool on the device, MaskData): no RLE. A single
        crop or the device crop paths read one small block of stats; the
        host crop path stitches on the host and uploads."""
        data, device_masks, orig_size = self._collect(image)
        if len(device_masks) == 1:
            masks = device_masks[0]
            return masks[torch.from_numpy(data["mask_slot"]).to(
                masks.device)], data
        return torch.from_numpy(self._masks_to_host(
            data, device_masks, orig_size)).to(self.device), data

    def generate_dense_batch(self, images) -> List[Tuple[Tensor, MaskData]]:
        """Single crop: every image's sweep is queued on the device before
        any stats are read. With crops, image by image. Returns [(masks on
        the device, MaskData)] per image."""
        if self.crop_n_layers:
            return [self.generate_dense(image) for image in images]
        handles = [self._process_crop(
            self._upload(image), [0, 0, image.shape[1], image.shape[0]], 0,
            defer=True) for image in images]
        results = []
        for handle in handles:
            data, masks, _ = self._collect_crop(*handle)
            data.filter(data["valid"])
            slots = data["mask_slot"]
            if not np.array_equal(slots, np.arange(masks.shape[0])):
                masks = masks[torch.from_numpy(slots).to(masks.device)]
            results.append((masks, data))
        return results

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image [H, W, 3] uint8 -> mask records (the upstream AMG output
        contract), sorted by area; ``crop_box`` is each mask's source
        crop."""
        data, device_masks, orig_size = self._collect(image)
        masks_full = self._masks_to_host(data, device_masks, orig_size)
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
        crop_col = (data["report_crop_boxes"] if "report_crop_boxes" in data
                    else data["crop_boxes"])
        records = []
        for i in range(K):
            crop_box = crop_col[i].astype(int).tolist()
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
