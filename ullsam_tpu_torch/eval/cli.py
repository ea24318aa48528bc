"""Evaluation CLI (``ullsam_tpu/eval/cli.py``; the reference's missing
eval_uLLSAM_seg.py / eval_language.py).

Modes:
  seg       point-prompted per-GT-instance segmentation (the app/training
            protocol: one positive click per instance at its centroid, the
            LLM-guided dense prompt) -> per-image AP / IoU / Dice
  seg_amg   automatic mask generation (16x16 points) -> AP vs GT instances
  lm        caption perplexity over a jsonl chat dataset

Usage:
  python -m ullsam_tpu_torch.eval.cli --mode seg --data_path data.jsonl \\
      --checkpoint ullsam.pt --tokenizer_path DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="uLLSAM evaluation (PyTorch)")
    p.add_argument("--mode", choices=["seg", "seg_amg", "lm"], default="seg")
    p.add_argument("--data_path", required=True)
    p.add_argument("--images_root", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="uLLSAM .pt (the reference's names)")
    p.add_argument("--sam_variant", default="vit_b")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--baseline", action="store_true",
                   help="no LLM dense prompt (ablation)")
    p.add_argument("--output", default=None, help="write metrics json here")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when there is no card")
    return p


def sam_of(model):
    """The SAM inside a ``ULLSAM`` as a module with ``Sam``'s parts (the
    same parameters), for the mask generator."""
    import torch

    sam = torch.nn.Module()
    sam.image_encoder = model.fusion.vision_model
    sam.prompt_encoder = model.prompt_encoder
    sam.mask_decoder = model.mask_decoder
    return sam


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from PIL import Image

    from ullsam_tpu_torch.core.device import resolve_device
    from ullsam_tpu_torch.data.datasets import (DatasetConfig, SegDataset,
                                                load_instance_map)
    from ullsam_tpu_torch.data.tokenizer import load_tokenizer
    from ullsam_tpu_torch.eval.seg_metrics import (aggregate,
                                                   average_precision,
                                                   instances_to_masks,
                                                   pixel_metrics)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.train.cli import make_configs

    device = resolve_device(args.device)
    cfg = make_configs(args)
    tokenizer = load_tokenizer(args.tokenizer_path)
    model = F.build_ullsam(cfg, device=device, seed=0)
    if args.checkpoint:
        from ullsam_tpu_torch.convert import reference as R
        from ullsam_tpu_torch.convert.from_jax import \
            load_reference_state_dict
        load_reference_state_dict(model, R.convert_fusion_state_dict(
            R.load_torch_state_dict(args.checkpoint)))

    size = cfg.sam.vit.img_size
    dcfg = DatasetConfig(data_path=args.data_path,
                         images_root=args.images_root, img_size=size,
                         num_image_token=cfg.num_image_token,
                         max_length=1280 if not args.tiny else 192)
    ds = SegDataset(dcfg, tokenizer)
    n = min(len(ds), args.limit) if args.limit else len(ds)

    results = []
    if args.mode in ("seg", "seg_amg"):
        from ullsam_tpu_torch.models.ullsam.chat import (point_segment,
                                                         segment_forward)

        gen = None
        if args.mode == "seg_amg":
            from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
            gen = AutomaticMaskGenerator(cfg.sam, sam_of(model),
                                         points_per_side=16)
        for i in range(n):
            row = ds.rows[i]
            pixel = np.asarray(Image.open(row["image_path"]).convert("RGB")
                               .resize((size, size)))
            model_in = pixel.astype(np.float32)[None] / 255.0
            mask_path = (row.get("mask_path")
                         or row["image_path"].replace("images", "masks"))
            gt_map = load_instance_map(mask_path, size)
            gt = instances_to_masks(gt_map)

            if gen is not None:
                recs = gen.generate(pixel.astype(np.uint8))
                pred = (np.stack([r["segmentation"] for r in recs])
                        if recs else np.zeros((0,) + gt_map.shape, bool))
            else:
                dense, feats = segment_forward(model, cfg, tokenizer,
                                               model_in)
                if args.baseline:
                    dense = None
                preds = []
                for g in gt:  # one positive click per GT instance centroid
                    ys, xs = np.nonzero(g)
                    cy, cx = float(ys.mean()), float(xs.mean())
                    m, _, _ = point_segment(
                        model, cfg, feats, dense,
                        np.asarray([[[cx, cy]]], np.float32),
                        np.asarray([[1]], np.int64))
                    preds.append(m[0, 0].cpu().numpy())
                pred = (np.stack(preds) if preds
                        else np.zeros((0,) + gt_map.shape, bool))

            m = average_precision(pred, gt)
            m.update(pixel_metrics(pred.any(0) if len(pred) else
                                   np.zeros_like(gt_map, bool),
                                   gt.any(0) if len(gt) else
                                   np.zeros_like(gt_map, bool)))
            results.append(m)
            print(f"[{i+1}/{n}] map={m['map']:.3f} ap50={m['ap50']:.3f} "
                  f"dice={m['dice']:.3f}")
    else:  # lm perplexity
        for i in range(n):
            ex = ds.example(i)
            with torch.no_grad():
                out = F.fusion_forward(
                    model, cfg,
                    torch.as_tensor(ex["pixel_values"][None], device=device),
                    torch.as_tensor(ex["input_ids"][None], device=device,
                                    dtype=torch.long),
                    attention_mask=torch.as_tensor(
                        ex["attention_mask"][None], device=device),
                    labels=torch.as_tensor(ex["labels"][None],
                                           device=device, dtype=torch.long))
            nll = float(out["loss"])
            results.append({"nll": nll, "ppl": float(np.exp(min(nll, 20)))})
            print(f"[{i+1}/{n}] nll={nll:.3f}")

    summary = aggregate(results)
    print(json.dumps(summary, indent=2, sort_keys=True))
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"summary": summary, "per_image": results}, f)
    return summary


if __name__ == "__main__":
    main()
