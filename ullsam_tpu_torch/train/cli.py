"""Training CLI (``ullsam_tpu/train/cli.py``): the pretrain / sft / segment
/ segment_baseline modes with the JAX CLI's flags, defaults and loop.

Replaces the reference's train.py + train_joint_v2.py +
train_joint_v2_baseline.py. As in the JAX CLI: one entry point, explicit
store_true / choices flags, the vision tower once per step, a true resume
(``train/checkpoint.py``), and the reference's hyperparameters of record
(scripts/train_all_joint_v2.sh: 24 epochs, batch 1, grad_accum 8, lr 1e-3).

New here: ``--device`` (default ``cuda``; with no card it raises rather
than falling back to the CPU).

Parallelism: one process a rank, started by a launcher (torchrun's
``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK``, or the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``;
``parallel/distributed.py``). The ranks form a ``--dp`` x ``--tp`` mesh
(``--dp 0``: world size // tp; the world size must be dp * tp). The
parameters are sharded over ``--tp`` by ``parallel/partitioning.py``'s
rules. ``--batch_size`` is the global batch of a micro-step, as in the JAX
CLI on one host: data rank r takes the r-th of every dp rows of the
epoch's order (``batch_iterator_sharded(process_index=r,
process_count=dp)``), ``batch_size / dp`` of them (dp must divide it), so
a global step holds the same rows as one process's, and the losses are
the whole batch's. Printing, metrics, overlays and checkpoint writes
happen on rank 0.

Usage:
  python -m ullsam_tpu_torch.train.cli --mode segment --data_path data.jsonl \\
      --tokenizer_path /path/to/tokenizer_dir --output_dir runs/seg
  python -m ullsam_tpu_torch.train.cli --tiny --device cpu ...   # on a CPU
  torchrun --nproc_per_node 8 -m ullsam_tpu_torch.train.cli --tp 2 ...
"""

from __future__ import annotations

import argparse
import os

SEG_MODES = ("segment", "segment_baseline")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="uLLSAM trainer (PyTorch)")
    # run
    p.add_argument("--mode", choices=["pretrain", "sft", "segment",
                                      "segment_baseline"], default="segment")
    p.add_argument("--output_dir", default="runs/default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when there is no card")
    # data
    p.add_argument("--data_path", required=True)
    p.add_argument("--images_root", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--max_length", type=int, default=1280)
    p.add_argument("--pack", action="store_true",
                   help="pretrain/sft only: pack several samples per row "
                        "with segment ids (varlen flash attention) instead "
                        "of one padded sample per row")
    p.add_argument("--img_size", type=int, default=1024)
    p.add_argument("--num_pos_points", type=int, default=1)
    p.add_argument("--num_neg_points", type=int, default=3)
    p.add_argument("--sam_max_point_bs", type=int, default=4)
    # model
    p.add_argument("--sam_variant", default="vit_b")
    p.add_argument("--sam_checkpoint", default=None)
    p.add_argument("--llm_checkpoint_dir", default=None,
                   help="HF safetensors dir for InternLM2")
    p.add_argument("--fusion_checkpoint", default=None,
                   help="uLLSAM .pt checkpoint (full model warm start)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny configs for smoke tests")
    # optimization (reference hyperparams of record,
    # scripts/train_all_joint_v2.sh)
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--batch_size", type=int, default=1,
                   help="global rows a micro-step; each data rank takes "
                        "batch_size / dp of them")
    p.add_argument("--grad_accum", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--freeze_vision", action="store_true")
    p.add_argument("--instance_matching", choices=["indexed", "hungarian"],
                   default="indexed",
                   help="hungarian = re-match preds to GTs by soft IoU "
                        "(working variable_instance_loss analog)")
    p.add_argument("--param_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="cast all floating params after init/warm-start; "
                        "bfloat16 matches the reference's deepspeed-bf16 "
                        "training (train_joint_v2.py)")
    p.add_argument("--trainable_modules", default=None,
                   help="comma-separated path regexes overriding defaults")
    # parallelism
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks; 0 = world size // tp")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (dp * tp = world size)")
    # logging / ckpt
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--image_log_every", type=int, default=-1,
                   help="overlay-image logging interval in steps; -1 = "
                        "20*log_every (the reference's cadence, "
                        "train_joint_v2.py:1125), 0 = off")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=0, help="0 = by epochs")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true")
    return p


def make_configs(args):
    from ullsam_tpu_torch.core.config import (SAM_REGISTRY, FusionConfig,
                                              InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig, internlm2_1_8b)

    if args.tiny:
        return FusionConfig(
            sam=SamConfig(
                vit=ViTConfig(img_size=64, patch_size=8, embed_dim=16,
                              depth=2, num_heads=2, mlp_ratio=2.0,
                              out_chans=16, window_size=2,
                              global_attn_indexes=(1,)),
                prompt_encoder=PromptEncoderConfig(
                    embed_dim=16, image_embedding_size=(8, 8),
                    input_image_size=(64, 64), mask_in_chans=8),
                mask_decoder=MaskDecoderConfig(
                    transformer_dim=16, transformer_mlp_dim=32,
                    transformer_num_heads=2, iou_head_hidden_dim=8)),
            llm=InternLM2Config(vocab_size=92553, hidden_size=32,
                                intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=2),
            vit_feature_dim=16)
    return FusionConfig(sam=SAM_REGISTRY[args.sam_variant](),
                        llm=internlm2_1_8b())


def make_mesh(args):
    """Start the process group the launcher describes (none for one
    process) and lay its ranks out as ``--dp`` x ``--tp``; raises
    ``ValueError`` when the world size is not dp * tp."""
    from ullsam_tpu_torch.parallel import distributed as D
    from ullsam_tpu_torch.parallel.partitioning import create_mesh

    D.initialize(device=args.device)
    dp = args.dp or max(1, D.process_count() // args.tp)
    mesh = create_mesh(dp=dp, tp=args.tp)
    if args.batch_size % dp:
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple "
                         f"of dp={dp}")
    return mesh


def load_warm_starts(model, args) -> None:
    """--sam_checkpoint (a SAM .pth, ``registry.load_sam_state_dict``),
    --llm_checkpoint_dir (HF safetensors shards, keys under
    ``language_model.``) and --fusion_checkpoint (a uLLSAM .pt, which
    replaces everything), in that order."""
    from ullsam_tpu_torch.convert import reference as R
    from ullsam_tpu_torch.convert.from_jax import load_reference_state_dict

    if args.sam_checkpoint:
        from ullsam_tpu_torch.models.sam.registry import load_sam_state_dict
        sd = load_sam_state_dict(args.sam_checkpoint)
        load_reference_state_dict(model.fusion.vision_model, sd,
                                  "image_encoder.")
        load_reference_state_dict(model.prompt_encoder, sd, "prompt_encoder.")
        load_reference_state_dict(model.mask_decoder, sd, "mask_decoder.")
    if args.llm_checkpoint_dir:
        load_reference_state_dict(
            model.fusion.language_model,
            R.load_internlm2_safetensors(args.llm_checkpoint_dir,
                                         prefix="language_model."))
    if args.fusion_checkpoint:
        load_reference_state_dict(model, R.convert_fusion_state_dict(
            R.load_torch_state_dict(args.fusion_checkpoint)))


def main(argv=None):
    """Train as the flags say; returns the model (its final weights)."""
    args = build_parser().parse_args(argv)

    import torch

    from ullsam_tpu_torch.core.device import resolve_device
    from ullsam_tpu_torch.data.datasets import (DatasetConfig,
                                                PrefetchIterator,
                                                PretrainDataset, SegDataset,
                                                SFTDataset,
                                                batch_iterator_sharded,
                                                packed_batch_iterator_sharded)
    from ullsam_tpu_torch.data.tokenizer import load_tokenizer
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops.resize import bilinear_resize_nhwc
    from ullsam_tpu_torch.parallel import distributed as D
    from ullsam_tpu_torch.parallel.partitioning import shard_params
    from ullsam_tpu_torch.train.checkpoint import (CheckpointManager,
                                                   restore_state, save_state)
    from ullsam_tpu_torch.train.metrics import (MetricWriter, StepTimer,
                                                segmentation_overlay)
    from ullsam_tpu_torch.train.step import (TrainConfig, batch_on,
                                             make_pred_masks_fn,
                                             make_train_step,
                                             make_trainable_optimizer)
    from ullsam_tpu_torch.utils.logging import log0

    device = resolve_device(args.device)
    mesh = make_mesh(args)
    if device.type == "cuda" and mesh.backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    main_rank = D.is_main_process()
    cfg = make_configs(args)
    tokenizer = load_tokenizer(args.tokenizer_path)

    dcfg = DatasetConfig(
        data_path=args.data_path, images_root=args.images_root,
        max_length=args.max_length, img_size=cfg.sam.vit.img_size,
        num_image_token=cfg.num_image_token,
        num_pos_points=args.num_pos_points,
        num_neg_points=args.num_neg_points,
        sam_max_point_bs=args.sam_max_point_bs)
    if args.mode == "pretrain":
        dataset = PretrainDataset(dcfg, tokenizer)
    elif args.mode == "sft":
        dataset = SFTDataset(dcfg, tokenizer)
    else:
        dataset = SegDataset(dcfg, tokenizer)

    # model init (float32, from the seed) + warm starts
    model = F.build_ullsam(cfg, device=device, seed=args.seed)
    load_warm_starts(model, args)

    steps_per_epoch = max(1, len(dataset) //
                          (args.batch_size * max(1, args.grad_accum)))
    total_steps = args.max_steps or steps_per_epoch * args.epochs

    seg_mode = args.mode in SEG_MODES
    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        total_steps=total_steps, warmup_ratio=args.warmup_ratio,
        max_grad_norm=args.max_grad_norm,
        seg_weight=1.0 if seg_mode else 0.0,
        llm_weight=0.0 if seg_mode else 1.0,
        use_llm_hidden_states=(args.mode == "segment"),
        freeze_vision=args.freeze_vision,
        instance_matching=args.instance_matching,
        trainable_patterns=(
            tuple(args.trainable_modules.split(","))
            if args.trainable_modules else
            ((r"sam\..*", r"mlp1\..*", r"mlp2\..*") if seg_mode
             else (r"llm\..*", r"mlp1\..*", r"mlp2\..*"))))

    if args.param_dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    shard_params(model, mesh)
    opt = make_trainable_optimizer(model, tcfg,
                                   grad_accum=max(1, args.grad_accum))
    step_fn = make_train_step(cfg, tcfg, model, opt)

    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    if main_rank:       # rank 0 clears a cut-short save before the others
        ckpt = CheckpointManager(ckpt_dir)
    D.barrier()
    if not main_rank:
        ckpt = CheckpointManager(ckpt_dir)
    writer = (MetricWriter(os.path.join(args.output_dir, "logs"),
                           use_tensorboard=args.tensorboard,
                           use_wandb=args.wandb) if main_rank else None)

    img_every = (20 * args.log_every if args.image_log_every < 0
                 else args.image_log_every)
    pred_fn = make_pred_masks_fn(cfg, tcfg) if img_every and seg_mode \
        else None

    start_step, start_epoch = 0, 0
    if args.resume and ckpt.latest_step() is not None:
        extra = restore_state(ckpt, opt, map_location=device)
        start_step = int(extra.get("step", ckpt.latest_step()))
        start_epoch = int(extra.get("epoch", 0))
        log0(f"resumed from step {start_step} (epoch {start_epoch})")

    def save(step, epoch, wait=False):
        save_state(ckpt, step, opt, extra={"step": step, "epoch": epoch},
                   wait=wait)

    # this data rank's share of each global batch (the module docstring)
    rows = args.batch_size // mesh.dp
    shard = dict(process_index=mesh.data_index, process_count=mesh.dp)
    if args.pack and args.mode in ("pretrain", "sft"):
        def make_iter(epoch):
            return packed_batch_iterator_sharded(
                dataset, rows, args.max_length, tokenizer.pad_token_id,
                seed=args.seed, epoch=epoch, **shard)
    else:
        def make_iter(epoch):
            return batch_iterator_sharded(dataset, rows, seed=args.seed,
                                          epoch=epoch, **shard)

    timer = StepTimer()
    step = start_step
    for epoch in range(start_epoch, args.epochs):
        for batch in PrefetchIterator(make_iter(epoch)):
            if args.max_steps and step >= args.max_steps:
                break
            timer.start()
            b = batch_on(model, batch)
            metrics = step_fn(b)
            float(metrics["loss"])  # sync
            step += 1
            if step % args.log_every == 0 and main_rank:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(timer.stop(args.batch_size))
                writer.write(step, m)
                log0(f"epoch {epoch} step {step}: " +
                     " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if pred_fn is not None and step % img_every == 0:
                # pred-vs-GT boundary overlay (train_joint_v2.py:1125-1167);
                # every rank runs the forward (its collectives), rank 0
                # draws its first row
                pred = pred_fn(model, b)
                if main_rank:
                    pred0 = pred[0, 0].cpu().numpy() > 0.0  # sigmoid > 0.5
                    gt0 = b["masks"][0, 0].cpu().numpy() > 0.5
                    img0 = b["pixel_values"][0].float()
                    if tuple(img0.shape[:2]) != pred0.shape:
                        img0 = bilinear_resize_nhwc(img0[None],
                                                    *pred0.shape)[0]
                    iou_val = float(metrics.get("iou", 0.0))
                    writer.log_image(
                        step, "segmentation_example",
                        segmentation_overlay(img0.cpu().numpy(), pred0, gt0),
                        caption=(f"Epoch {epoch}, Step {step}, "
                                 f"IoU: {iou_val:.4f}"))
            if step % args.ckpt_every == 0:
                save(step, epoch)
        save(step, epoch + 1, wait=True)
    if writer is not None:
        writer.close()
    ckpt.close()
    log0(f"done at step {step}; checkpoints in {args.output_dir}/ckpt")
    return model


if __name__ == "__main__":
    main()
