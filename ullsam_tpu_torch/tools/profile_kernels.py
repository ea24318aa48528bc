"""Where the time goes on the card: torch.profiler over the port's kernels
at the main path's shapes, over one full segmentation request, one
automatic-mask-generation image, one flagship train step, one packed sft
step and steady caption decode steps in bf16 and with the int8 LLM (inputs
from ``tools/main_path.py``, as ``chip_smoke.py`` checks and times them),
and over one warm SAM ViT-H AMG image and its encode under each route
setting of the JAX package's switches (regions ``vit_h_*``).

    python -m ullsam_tpu_torch.tools.profile_kernels [--out DIR] [--only P]

``--only P`` profiles just the regions whose names start with P (their
set-up still runs; ``--only vit_h`` sets up only the ViT-H model).

Prints, per profiled region, the CUDA kernels by total device time (the
hand-written kernels' sub-kernels appear by name), the device-busy total
and the region's wall time, so the idle share is wall - busy; for caption
decode also the host time of one call of a decode-size linear, bf16
``Linear`` against the int8 ``QuantLinear`` (B12). Writes a
chrome trace per region under DIR when given. Needs a CUDA card; TF32 is
off for float32.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                          sam_vit_b)
from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
from ullsam_tpu_torch.models.internlm2 import model as LLM
from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
from ullsam_tpu_torch.models.sam import sam as SM
from ullsam_tpu_torch.models.sam.registry import build_sam
from ullsam_tpu_torch.models.sam.sam import Sam
from ullsam_tpu_torch.models.ullsam import chat
from ullsam_tpu_torch.models.ullsam import fusion as F
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import decoder as D
from ullsam_tpu_torch.ops.kernels import flash_attention as FA
from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
from ullsam_tpu_torch.ops.kernels import vit_block as VB
from ullsam_tpu_torch.ops.kernels import window_attention as WA
from ullsam_tpu_torch.tools.main_path import (AMG_CHUNK, FLASH_BWD,
                                              LLM_FLASH, SFT_TRAIN,
                                              VIT_H_ROUTES, WINDOW_CORE,
                                              amg_inputs, caption_inputs,
                                              decoder_cases,
                                              llm_flash_case,
                                              packed_train_batch,
                                              request_inputs, switches,
                                              train_batch,
                                              vit_flash_bwd_case,
                                              vit_flash_case,
                                              window_attn_case,
                                              window_core_case)
from ullsam_tpu_torch.train import step as S


def _region(name: str, fn, args, iters: int = 3, top: int = 12) -> None:
    """Profile ``fn`` as region ``name`` unless ``args.only`` excludes it;
    a chrome trace goes to ``args.out`` when given."""
    if not name.startswith(args.only):
        return
    fn()  # warm up: builds, cuBLAS handles, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3 / iters, e.count // iters, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"== {name}: wall {wall:.3f} ms/iter, device busy {busy:.3f} "
          f"ms/iter ({100 * busy / wall:.1f}%), idle "
          f"{max(wall - busy, 0):.3f} ms, {sum(r[1] for r in rows)} device "
          f"kernels and copies/iter")
    for ms, count, key in rows[:top]:
        print(f"   {ms:9.4f} ms  x{count:<4d} {key[:90]}")
    if args.out:
        prof.export_chrome_trace(os.path.join(args.out, f"{name}.json"))


def _host_us(fn, n: int = 200) -> float:
    """Host time of one ``fn()`` call: ``n`` calls back to back with no
    synchronize inside (the card runs them behind), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def _vit_h(args) -> None:
    """SAM ViT-H in bf16 (random weights, seed 0): one warm AMG image
    (32x32 points in chunks of 256, thresholds and NMS off, 256 masks) on
    the default route, and the encode of that image under each route."""
    cfg, sam = build_sam("vit_h", seed=0, device="cuda",
                         dtype=torch.bfloat16)
    amg = AutomaticMaskGenerator(
        cfg, sam, points_per_side=32, points_per_batch=256,
        pred_iou_thresh=0.0, stability_score_thresh=0.0, box_nms_thresh=1.0,
        max_masks=256)
    image = amg_inputs(np.random.default_rng(0), 1)[0]
    with switches({}):
        _region("vit_h_amg_image_bfloat16",
                lambda: amg.generate_dense(image), args, iters=2, top=25)
    x = SM.preprocess(torch.from_numpy(image).cuda().float()[None],
                      cfg).to(torch.bfloat16)
    for route, env in VIT_H_ROUTES.items():
        with switches(env), torch.no_grad():
            _region(f"vit_h_encode_bfloat16_{route}",
                    lambda: SM.encode_image(sam.image_encoder, x), args,
                    iters=3, top=15)
    del sam, amg
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="chrome trace directory")
    ap.add_argument("--only", default="", help="region name prefix")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _vit_h(args)
    if args.only.startswith("vit_h"):
        return
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        b1, kw, _, _ = window_attn_case(dtype, gen)
        _region(f"window_attn_{dn}", lambda: VB.window_attn(*b1, **kw),
                args)
        b2, _, _, _ = vit_flash_case(dtype, gen)
        _region(f"vit_flash_attn_{dn}", lambda: FA.vit_flash_attn(*b2),
                args)

        _, b8, _, _ = window_core_case(dtype, gen, **WINDOW_CORE)
        _region(f"window_attn_core_bwd_{dn}",
                lambda: WA.window_attn_core_bwd(*b8), args)
        b9, _, _ = vit_flash_bwd_case(dtype, gen, **FLASH_BWD)
        _region(f"vit_flash_attn_bwd_{dn}",
                lambda: FA.vit_flash_attn_bwd(*b9), args)
        del b8, b9
        b10, b11, kw, _, _ = llm_flash_case(dtype, gen, **LLM_FLASH)
        _region(f"llm_flash_attn_{dn}", lambda: LF.llm_flash_attn(*b10, **kw),
                args)
        _region(f"llm_flash_attn_bwd_{dn}",
                lambda: LF.llm_flash_attn_bwd(*b11, **kw), args)
        del b10, b11

        b4, kw, _, _ = decoder_cases(dtype, gen, **AMG_CHUNK)["decode_masks"]
        _region(f"decode_masks_{dn}", lambda: D.decode_masks(*b4, **kw),
                args, top=20)

    sam = Sam(sam_vit_b(), device="cuda")
    L.init_module_(sam, gen)
    amg = AutomaticMaskGenerator(
        sam_vit_b(), sam.to(torch.bfloat16), points_per_side=32,
        points_per_batch=256, pred_iou_thresh=0.0, stability_score_thresh=0.0,
        box_nms_thresh=1.0, max_masks=256)
    image = amg_inputs(np.random.default_rng(0), 1)[0]
    _region("amg_image_bfloat16", lambda: amg.generate_dense(image),
            args, iters=2, top=25)
    del sam, amg
    torch.cuda.empty_cache()

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    model = F.build_ullsam(cfg, dtype=torch.bfloat16, seed=0)
    pixels, ids, coords, labels = request_inputs(
        cfg, np.random.default_rng(0), 1)

    def request():
        dense, feats = chat.segment_prefill(model, cfg, pixels, ids)
        chat.point_segment(model, cfg, feats, dense, coords, labels)

    _region("request_bfloat16", request, args, iters=2, top=25)

    # the flagship train step (bf16 parameters and moments, remat off); the
    # updates run at lr 0 only on the first step, so later ones move weights
    tcfg = S.TrainConfig(total_steps=100, remat=False)
    step = S.make_train_step(cfg, tcfg, model,
                             S.make_trainable_optimizer(model, tcfg))
    batch = S.batch_on(model, train_batch(cfg, np.random.default_rng(0)))
    _region("train_step_bfloat16", lambda: step(batch), args, iters=2,
            top=30)
    del step, batch

    # the packed sft step (--mode sft --pack, S = 2560): the LLM, mlp1 and
    # mlp2 train with bf16 moments, SAM frozen, remat on
    tcfg = S.TrainConfig(total_steps=100, **SFT_TRAIN)
    step = S.make_train_step(cfg, tcfg, model,
                             S.make_trainable_optimizer(model, tcfg))
    batch = S.batch_on(model, packed_train_batch(cfg,
                                                 np.random.default_rng(0)))
    _region("packed_sft_step_bfloat16", lambda: step(batch), args,
            iters=2, top=30)
    del step, batch
    torch.cuda.empty_cache()

    # steady caption decode steps at batch 1 after the 1152-token prompt's
    # prefill, bf16 then with the LLM's linears int8 (B12, 121 a step)
    for tag in ("bfloat16", "int8"):
        if tag == "int8":
            quantize_llm_int8(model.fusion.language_model)
            torch.cuda.empty_cache()
        lm = model.fusion.language_model
        pixels, ids, mask = caption_inputs(cfg, np.random.default_rng(0))
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).cuda()
            embeds = chat.embeds_with_image(model, cfg, ids_t,
                                            torch.from_numpy(pixels).cuda())
            cache = LLM.init_cache(cfg.llm, 1, ids.shape[1] + 16,
                                   dtype=embeds.dtype, device="cuda")
            out, cache = LLM.internlm2_prefill(
                lm, cfg.llm, embeds, torch.from_numpy(mask).cuda(), cache)
            tok = out["logits"][:, -1].argmax(-1)
            del out

        def decode_step():
            with torch.inference_mode():
                emb = LLM.embed_tokens(lm, tok)[:, None]
                LLM.internlm2_decode_step(lm, cfg.llm, emb, cache)

        _region(f"caption_decode_{tag}", decode_step, args, iters=8,
                top=25)
        if "caption_host".startswith(args.only):
            w1 = lm.model.layers[0].feed_forward.w1
            x = torch.randn(1, 1, cfg.llm.hidden_size, device="cuda",
                            dtype=embeds.dtype)
            with torch.inference_mode():
                print(f"== caption_host_{tag}: the w1 module at decode "
                      f"({type(w1).__name__}) {_host_us(lambda: w1(x)):.1f} "
                      f"us of host time a call (200 calls, no sync)")


if __name__ == "__main__":
    main()
