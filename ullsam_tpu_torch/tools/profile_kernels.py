"""Where the time goes on the card: torch.profiler over the port's kernels
at the main path's shapes, over one full segmentation request, one
automatic-mask-generation image (bf16 and f32), one flagship train step,
one packed sft step (bf16, and ``packed_sft_step_float32``) and steady
caption decode steps in bf16 and with the
int8 LLM (inputs
from ``tools/main_path.py``, as ``chip_smoke.py`` checks and times them),
and over one warm SAM ViT-H AMG image and its encode under each route
setting of the JAX package's switches (regions ``vit_h_*``), one ViT-H
segmentation train step (``vit_h_train_step_bfloat16``: SAM ViT-H +
frozen InternLM2-1.8B, bf16 parameters and moments, remat off), the
float32 steps (``vit_h_train_step_float32`` with and without ``_remat``,
``vit_b_train_step_float32_remat``: the JAX CLI's defaults) and a SAM
ViT-B encode (``vit_b_encode_bfloat16``, the interactive request's), and
the serving engine's work in bf16 and int8 (``serve_admit_*``: one image
caption request's admission, the encode, 5 prefill segments of 256, the
first token and the splice; ``serve_chunk_*``: one decode chunk of 8
steps over 8 rows at the image prompt's length, replayed from its captured
CUDA graph), and the calibrated production AMG (``amg_prod_*``: SAM ViT-B
through ``calibrate_amg_weights`` in bf16, 0.88 / 0.95 / NMS 0.7, one
image and one image with one crop layer).

    python -m ullsam_tpu_torch.tools.profile_kernels [--out DIR] [--only P]

``--only P[,P2...]`` profiles just the regions whose names start with one
of the prefixes, and sets up only what they need.

Prints, per profiled region, the CUDA kernels by total device time (the
hand-written kernels' sub-kernels appear by name), the device-busy total,
the region's wall time, so the idle share is wall - busy, and its peak
device memory above what was allocated before it; for caption
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
                                          sam_vit_b, sam_vit_h)
from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
from ullsam_tpu_torch.inference.calibrate import calibrate_amg_weights
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


def _wants(args, *names: str) -> bool:
    """Whether ``--only`` selects a region of one of these names."""
    return any(n.startswith(p) for n in names
               for p in args.only.split(","))


def _region(name: str, fn, args, iters: int = 3, top: int = 12) -> None:
    """Profile ``fn`` as region ``name`` unless ``args.only`` excludes it;
    a chrome trace goes to ``args.out`` when given."""
    if not _wants(args, name):
        return
    fn()  # warm up: builds, cuBLAS handles, caches
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
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
          f"kernels and copies/iter, peak "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB "
          f"above the {held / 2**20:.1f} MiB held before it")
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


def _amg_prod(args) -> None:
    """The calibrated production AMG (``chip_smoke.py`` phase 13 (a), (b)):
    SAM ViT-B (random weights, seed 0) calibrated and cast to bf16, the
    generator's default thresholds (0.88 / 0.95 / NMS 0.7), 32x32 points in
    chunks of 256, at most 256 masks; one image, then one crop layer."""
    cfg, sam = build_sam("vit_b", seed=0, device="cuda")
    sam = calibrate_amg_weights(sam, cfg).to(torch.bfloat16)
    image = amg_inputs(np.random.default_rng(0), 1)[0]
    for name, layers in (("amg_prod_image_bfloat16", 0),
                         ("amg_prod_multicrop_image_bfloat16", 1)):
        amg = AutomaticMaskGenerator(cfg, sam, points_per_side=32,
                                     points_per_batch=256, max_masks=256,
                                     crop_n_layers=layers)
        _region(name, lambda: amg.generate_dense(image), args, iters=2,
                top=25)
    del sam, amg
    torch.cuda.empty_cache()


def _vit_h_train(args) -> None:
    """The segmentation train step at SAM ViT-H + frozen InternLM2-1.8B
    (``chip_smoke.py`` phase 11 (a)): bf16 parameters and moments, remat
    off, random weights (seed 0), the flagship batch; the default route."""
    cfg = FusionConfig(sam=sam_vit_h(), llm=internlm2_1_8b())
    model = F.build_ullsam(cfg, dtype=torch.bfloat16, seed=0)
    tcfg = S.TrainConfig(total_steps=100, remat=False)
    step = S.make_train_step(cfg, tcfg, model,
                             S.make_trainable_optimizer(model, tcfg))
    batch = S.batch_on(model, train_batch(cfg, np.random.default_rng(0)))
    with switches({}):
        _region("vit_h_train_step_bfloat16", lambda: step(batch), args,
                iters=2, top=30)
    del model, step, batch
    torch.cuda.empty_cache()


# the float32 segmentation train steps profiled: (variant, remat); with
# remat the JAX CLI's defaults (--param_dtype float32, remat on)
F32_STEPS = (("vit_h", True), ("vit_h", False), ("vit_b", True))


def _f32_step_name(variant: str, remat: bool) -> str:
    return f"{variant}_train_step_float32{'_remat' if remat else ''}"


def _train_f32(args, variant: str, remat: bool) -> None:
    """One float32 segmentation train step (parameters and moments f32,
    TF32 off in PyTorch; B8 and B9 in split TF32) at SAM ``variant`` +
    frozen InternLM2-1.8B, random weights (seed 0), the flagship batch.
    With remat the windows run plain and the global blocks B2 8, B9 4 a
    step; without it B1, B3 and B8 in the windowed blocks too
    (``chip_smoke.py`` phases 7 and 11 (b), (c))."""
    name = _f32_step_name(variant, remat)
    if not _wants(args, name):
        return
    sam = sam_vit_h() if variant == "vit_h" else sam_vit_b()
    cfg = FusionConfig(sam=sam, llm=internlm2_1_8b())
    model = F.build_ullsam(cfg, dtype=torch.float32, seed=0)
    tcfg = S.TrainConfig(total_steps=100, remat=remat)
    step = S.make_train_step(cfg, tcfg, model,
                             S.make_trainable_optimizer(model, tcfg))
    batch = S.batch_on(model, train_batch(cfg, np.random.default_rng(0)))
    with switches({}):
        _region(name, lambda: step(batch), args, iters=2, top=30)
    del model, step, batch
    torch.cuda.empty_cache()


def _vit_b_encode(args) -> None:
    """SAM ViT-B in bf16 (random weights, seed 0): the encode of one
    1024x1024 image, the interactive request's first stage (B1 8, B2 4)."""
    cfg, sam = build_sam("vit_b", seed=0, device="cuda",
                         dtype=torch.bfloat16)
    image = amg_inputs(np.random.default_rng(0), 1)[0]
    x = SM.preprocess(torch.from_numpy(image).cuda().float()[None],
                      cfg).to(torch.bfloat16)
    with switches({}), torch.no_grad():
        _region("vit_b_encode_bfloat16",
                lambda: SM.encode_image(sam.image_encoder, x), args,
                iters=3, top=15)
    del sam
    torch.cuda.empty_cache()


def _packed_f32(args, cfg) -> None:
    """The packed sft step in float32 (the JAX CLI's default parameter
    dtype; TF32 off in PyTorch; B10 and B11 in split TF32): the same
    settings and batch as the bf16 region, on a float32 model built from
    the seed (about 31 GB with its moments and gradients, beside the bf16
    model)."""
    f32 = F.build_ullsam(cfg, dtype=torch.float32, seed=0)
    tcfg = S.TrainConfig(total_steps=100, **SFT_TRAIN)
    step = S.make_train_step(cfg, tcfg, f32,
                             S.make_trainable_optimizer(f32, tcfg))
    batch = S.batch_on(f32, packed_train_batch(cfg,
                                               np.random.default_rng(0)))
    _region("packed_sft_step_float32", lambda: step(batch), args, iters=2,
            top=30)
    del f32, step, batch
    torch.cuda.empty_cache()


class _ServeTokenizer:
    """The ids the engine asks of a tokenizer: EOS (the template's
    <|im_end|>) and pad."""
    pad_token_id = 2

    @staticmethod
    def convert_tokens_to_ids(token):
        return 92542


def _serve(args, model, cfg) -> None:
    """The engine's admission of one image caption request (1024 image +
    64 text tokens, 5 segments of 256) and one captured decode chunk (8
    steps, 8 active rows of 1,100 tokens, window 1536), bf16 and int8."""
    from ullsam_tpu_torch.serve.engine import GenerationEngine, Request
    rng = np.random.default_rng(0)
    ids = np.asarray([1, 11] + [cfg.img_context_token_id] * 1024
                     + rng.integers(3, 90000, 62).tolist(), np.int64)
    img = rng.integers(0, 256, (1, 1024, 1024, 3), dtype=np.uint8)
    for quant in (None, "int8"):
        tag = quant or "bfloat16"
        if not _wants(args, f"serve_admit_{tag}", f"serve_chunk_{tag}"):
            continue
        eng = GenerationEngine(model, cfg, _ServeTokenizer(), max_batch=8,
                               max_len=2560, quant=quant)
        eng.shutdown()            # its internals run on this thread
        st = eng.state

        def admit():
            pend = eng._admit_start(0, Request(ids, img, 128))
            while eng._admit_advance(pend) is None:
                pass

        with torch.inference_mode():
            _region(f"serve_admit_{tag}", admit, args, iters=3, top=25)
            st.cache.mask.zero_()
            st.cache.mask[:, :1100] = 1
            st.active.fill_(True)
            st.tokens.fill_(11)
            mask = st.cache.mask.clone()
            graph = eng._graph((8, 1536, False))

            def chunk():
                st.cache.mask.copy_(mask)
                graph.replay()

            _region(f"serve_chunk_{tag}", chunk, args, iters=8, top=25)
        del eng, graph
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
    if _wants(args, "vit_h_"):
        _vit_h(args)
    if _wants(args, "vit_h_train_step_bfloat16"):
        _vit_h_train(args)
    if _wants(args, "amg_prod_"):
        _amg_prod(args)
    for variant, remat in F32_STEPS:
        _train_f32(args, variant, remat)
    if _wants(args, "vit_b_encode_"):
        _vit_b_encode(args)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kernel_regions = ("window_attn_", "vit_flash_attn_", "llm_flash_attn_",
                      "decode_masks_")
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        if not _wants(args, *kernel_regions):
            break
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

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        if not _wants(args, f"amg_image_{dn}"):
            continue
        sam = Sam(sam_vit_b(), device="cuda")
        L.init_module_(sam, gen)
        amg = AutomaticMaskGenerator(
            sam_vit_b(), sam.to(dtype), points_per_side=32,
            points_per_batch=256, pred_iou_thresh=0.0,
            stability_score_thresh=0.0, box_nms_thresh=1.0, max_masks=256)
        image = amg_inputs(np.random.default_rng(0), 1)[0]
        _region(f"amg_image_{dn}", lambda: amg.generate_dense(image),
                args, iters=2, top=25)
        del sam, amg
        torch.cuda.empty_cache()
    if not _wants(args, "request_", "train_step_", "packed_sft_step_",
                  "packed_sft_step_float32", "caption_", "serve_"):
        return

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
    if _wants(args, "packed_sft_step_float32"):
        _packed_f32(args, cfg)

    if _wants(args, "serve_"):
        _serve(args, model, cfg)

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
        if _wants(args, "caption_host_"):
            w1 = lm.model.layers[0].feed_forward.w1
            x = torch.randn(1, 1, cfg.llm.hidden_size, device="cuda",
                            dtype=embeds.dtype)
            with torch.inference_mode():
                print(f"== caption_host_{tag}: the w1 module at decode "
                      f"({type(w1).__name__}) {_host_us(lambda: w1(x)):.1f} "
                      f"us of host time a call (200 calls, no sync)")


if __name__ == "__main__":
    main()
