"""Drive the PyTorch port (``ullsam_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (H100,
sm_90a) and the CUDA toolkit. Phases, each printing what it found:

 1. device: the card, ``nvidia-smi`` name and power limit; no card -> exit 1.
 2. build: nvcc builds every kernel under ``ullsam_tpu_torch/csrc`` (one
    process per source, in parallel); ptxas registers / smem / spills.
 3. kernels: each kernel against its plain PyTorch version on the card at
    the main path's exact shapes, in float32 and bfloat16, with the stated
    tolerance; kernel, plain and (where one exists) library-call times with
    CUDA events; the least time the card could take (bound).
 4. small-input reference: a small uLLSAM on the CPU (plain versions) and
    on the card (kernels) from the same weights must agree.
 5. main path at full width: SAM ViT-B + InternLM2-1.8B (random weights
    from a seeded generator), 3 bfloat16 requests and 1 float32 request of
    the interactive-segmentation path (segment_prefill + point_segment),
    launch counters, latency, peak memory.
 6. automatic mask generation: a small ViT with SAM's full-width decoder on
    the CPU (plain versions) against the card (kernels); then SAM ViT-B at
    full width on 1024x1024 images (a 32x32 point grid, 256 prompts a
    chunk): the deterministic sweep (thresholds and NMS off) in bfloat16,
    1 warm and 3 timed images, one float32 image, and one bfloat16 image
    with the upstream thresholds (0.88 / 0.95 / NMS 0.7).
Each path (5 and 6) runs with every launch counter set to 0 just before it
and read just after. Then the kernels JSON line (``launches``: the sum over
both paths; ``launches_by_path``: each path's own count), the nvidia-smi
line, and the final status line.
Any failure exits non-zero before the final line. No jax, no ullsam_tpu.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (SXM data sheet)
H100_F32_FLOPS = 67e12     # f32 on the CUDA cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi gave nothing (rc {out.returncode})"


def ptxas_summary(report: str):
    """(kernel, registers, static smem, spill bytes) per kernel from an
    ``nvcc -Xptxas -v`` log; names demangled by c++filt where present."""
    rows, fn, spills = [], None, "0/0"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m and fn:
            rows.append([fn, m.group(1), m.group(2) or "0", spills])
            fn, spills = None, "0/0"
    try:
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=30)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r[0] = n.split("(")[0].removeprefix("void ")
    except (OSError, subprocess.TimeoutExpired):
        pass
    return rows


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    import torch
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.tools.main_path import (vit_flash_case,
                                                  window_attn_case)

    # tolerance on max|kernel - plain| relative to max|plain|: f32 differs
    # only in summation order; bf16 also in which values round which way
    # at the cast points (a few bf16 ulps, 2^-8 relative each)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {}
    for name, case, kernel, plain, source, replaces in (
            ("window_attn", window_attn_case, VB.window_attn,
             VB.window_attn_plain, "ullsam_tpu_torch/csrc/window_attn.cu",
             "ullsam_tpu/ops/pallas/vit_block.py:203"),
            ("vit_flash_attn", vit_flash_case, FA.vit_flash_attn,
             FA.vit_flash_attn_plain,
             "ullsam_tpu_torch/csrc/vit_flash_attn.cu",
             "ullsam_tpu/ops/pallas/flash_attention.py:59")):
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces}
        for dtype in (torch.bfloat16, torch.float32):
            args, kw, flops, nbytes = case(dtype, gen)
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(outs, refs)]
            scales = [float(b.float().abs().max()) for b in refs]
            err = max(errs)
            rel = max(e / max(s, 1e-30) for e, s in zip(errs, scales))
            finite = all(bool(torch.isfinite(a).all()) for a in outs)
            dname = str(dtype).replace("torch.", "")
            ok = finite and rel <= tol[dtype]
            say(f"[kernels] {name} {dname}: max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} (per output, relative to max|plain|;"
                f" tol {tol[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            ms = cuda_time_ms(lambda: kernel(*args, **kw), iters=20)
            plain_ms = cuda_time_ms(lambda: plain(*args, **kw), iters=5,
                                    warmup=1)
            lib_ms = None
            if name == "vit_flash_attn":
                q, k, v, rh, rw = args
                BH, N, _ = q.shape
                bias = (rh[..., :, None] + rw[..., None, :]).reshape(BH, N, N)
                lib_ms = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], attn_mask=bias[None]),
                    iters=5, warmup=1)
                del bias
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            say(f"[kernels] {name} {dname}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; data-sheet peaks at 700 W, card: "
                f"{card}), {flops / ms / 1e9:.1f} TFLOP/s")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            if dtype == torch.bfloat16:
                row.update(entry)
            else:
                row["float32"] = entry
            del args, out, ref
            torch.cuda.empty_cache()
        rows[name] = row
    return rows


DECODER_KERNELS = (
    ("decode_masks", "ullsam_tpu_torch/csrc/decoder_twt.cu",
     "ullsam_tpu/ops/pallas/decoder.py:835"),
    ("two_way_transformer", "ullsam_tpu_torch/csrc/decoder_twt.cu",
     "ullsam_tpu/ops/pallas/decoder.py:637"),
    ("upscale_hypernet_stats", "ullsam_tpu_torch/csrc/decoder_upscale.cu",
     "ullsam_tpu/ops/pallas/decoder.py:107"),
    ("upscale_hypernet", "ullsam_tpu_torch/csrc/decoder_upscale.cu",
     "ullsam_tpu/ops/pallas/decoder.py:98"))


def check_decoder_kernels(card: str) -> dict:
    """B4-B7 against their plain versions at the AMG chunk of SAM ViT-B
    (256 prompts, 64x64 grid, 7 tokens, 3 masks), in bf16 and f32; the
    statistics exactly against the plain statistics of the kernel's own
    logits. No single PyTorch call computes any of them (library_ms null)."""
    import torch
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import (AMG_CHUNK, decoder_cases,
                                                  decoder_outputs)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {name: {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces}
            for name, source, replaces in DECODER_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        cases = decoder_cases(dtype, gen, **AMG_CHUNK)
        for name, _, _ in DECODER_KERNELS:
            args, kw, flops, nbytes = cases[name]
            kernel, plain = getattr(D, name), getattr(D, name + "_plain")
            got = kernel(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            g_f, g_i, logits = decoder_outputs(name, got)
            r_f, _, _ = decoder_outputs(name, ref)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(g_f, r_f))
            rel = max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max()) for a, b in zip(g_f, r_f))
            finite = all(bool(torch.isfinite(a).all()) for a in g_f)
            exact = g_i is None or all(
                torch.equal(a, b) for a, b in zip(
                    g_i, D.upscale_stats_plain(logits, kw["thr"], kw["off"])))
            ok = finite and rel <= tol[dtype] and exact
            say(f"[kernels] {name} {dname}: max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} (relative to max|plain|; tol "
                f"{tol[dtype]:.0e}), statistics "
                f"{'n/a' if g_i is None else 'exact' if exact else 'DIFFER'}"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            del got, ref, g_f, r_f, g_i, logits
            ms = cuda_time_ms(lambda: kernel(*args, **kw), iters=5,
                              warmup=1)
            plain_ms = cuda_time_ms(lambda: plain(*args, **kw), iters=2,
                                    warmup=1)
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            say(f"[kernels] {name} {dname}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library n/a, bound {b_ms:.4f} ms "
                f"({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
                f"data-sheet peaks at 700 W, card: {card}), "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            if dtype == torch.bfloat16:
                rows[name].update(entry)
            else:
                rows[name]["float32"] = entry
        del cases, args
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the port's main path
# ---------------------------------------------------------------------------


def run_request(model, cfg, inputs):
    import torch
    from ullsam_tpu_torch.models.ullsam import chat
    pixels, ids, coords, labels = inputs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense, feats = chat.segment_prefill(model, cfg, pixels, ids)
    mask, probs, iou = chat.point_segment(model, cfg, feats, dense, coords,
                                          labels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    g = cfg.feature_hw
    S = cfg.sam.vit.img_size
    for t, shape in ((dense, (1, g, g, cfg.vit_feature_dim)),
                     (feats, (1, g, g, cfg.vit_feature_dim)),
                     (mask, (1, 1, S, S)), (probs, (1, 1, S, S)),
                     (iou, (1, 1))):
        if tuple(t.shape) != shape:
            fail(f"output shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            fail("non-finite output")
    return ms, dense, feats, mask, probs, iou


def small_reference_check() -> None:
    """A small uLLSAM (hd = 64 so both kernels take it; a padded window
    grid and a global block) from one set of weights: plain versions on the
    CPU against the kernels on the card, in float32."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.tools.main_path import request_inputs

    cfg = FusionConfig(
        sam=SamConfig(
            vit=ViTConfig(img_size=256, patch_size=16, embed_dim=128,
                          depth=3, num_heads=2, out_chans=64, window_size=14,
                          global_attn_indexes=(1,)),
            prompt_encoder=PromptEncoderConfig(
                embed_dim=64, image_embedding_size=(16, 16),
                input_image_size=(256, 256)),
            mask_decoder=MaskDecoderConfig(transformer_dim=64,
                                           transformer_mlp_dim=128,
                                           transformer_num_heads=2,
                                           iou_head_hidden_dim=32)),
        llm=InternLM2Config(vocab_size=128, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=64, img_context_token_id=100)
    cpu = F.build_ullsam(cfg, device="cpu", seed=SEED)
    gpu = F.ULLSAM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    rng = np.random.default_rng(SEED)
    inputs = request_inputs(cfg, rng, 2, text_len=8)
    from ullsam_tpu_torch.models.ullsam import chat
    before = (VB.window_attn.launches, FA.vit_flash_attn.launches)
    ref = chat.segment_prefill(cpu, cfg, *inputs[:2])
    got = chat.segment_prefill(gpu, cfg, *inputs[:2])
    ref_m = chat.point_segment(cpu, cfg, ref[1], ref[0], *inputs[2:])
    got_m = chat.point_segment(gpu, cfg, got[1], got[0], *inputs[2:])
    if (VB.window_attn.launches - before[0] != 2
            or FA.vit_flash_attn.launches - before[1] != 1):
        fail("small model did not launch both kernels")
    worst = 0.0
    for name, a, b in (("dense_prompt", ref[0], got[0]),
                       ("sam_features", ref[1], got[1]),
                       ("mask_probs", ref_m[1], got_m[1]),
                       ("iou", ref_m[2], got_m[2])):
        err = float((a - b.cpu()).abs().max())
        worst = max(worst, err)
        say(f"[reference] small model, CPU plain vs GPU kernels, {name}: "
            f"max_abs_err={err:.3e}")
    # f32 everywhere with TF32 off: only summation order differs
    if worst > 1e-3:
        fail(f"small model GPU vs CPU max_abs_err {worst:.3e} > 1e-3")


def main_path() -> None:
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.tools.main_path import request_inputs

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    t0 = time.perf_counter()
    model32 = F.build_ullsam(cfg, device="cuda", dtype=torch.float32,
                             seed=SEED)
    model16 = F.ULLSAM(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    model16.eval()
    n_params = sum(p.numel() for p in model32.parameters())
    model32.to("cpu")  # one model on the card at a time, for its memory
    torch.cuda.empty_cache()
    say(f"[main] SAM ViT-B + InternLM2-1.8B, {n_params / 1e9:.3f} B params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    reqs = [request_inputs(cfg, rng, c) for c in (1, 2, 3)]

    def serve(model, name, inputs):
        """Requests on one resident model: per-request latency and
        launches, the first request's outputs, and the weights' bytes and
        the peak above them."""
        torch.cuda.synchronize()
        weights = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lat, per_req, first = [], [], None
        for i, inp in enumerate(inputs):
            b1, b2 = VB.window_attn.launches, FA.vit_flash_attn.launches
            ms, dense, feats, mask, probs, iou = run_request(model, cfg, inp)
            d1 = VB.window_attn.launches - b1
            d2 = FA.vit_flash_attn.launches - b2
            per_req.append((d1, d2))
            lat.append(ms)
            if i == 0:
                first = (dense.float(), feats.float(), probs)
            say(f"[main] {name} request {i}: {inp[2].shape[1]} click(s), "
                f"latency {ms:.1f} ms (host clock, ends in synchronize), "
                f"launches window_attn +{d1} vit_flash_attn +{d2}, "
                f"mask area {int(mask.sum())} px, iou {float(iou):.4f}")
        peak = torch.cuda.max_memory_allocated()
        say(f"[main] {name}: weights {weights / 2**30:.3f} GiB resident, "
            f"peak {peak / 2**30:.3f} GiB (max_memory_allocated), so "
            f"{(peak - weights) / 2**30:.3f} GiB for the requests")
        return lat, per_req, first

    _, per_req, bf16_first = serve(model16, "bf16", reqs)
    del model16
    torch.cuda.empty_cache()
    model32.to("cuda")
    say("[main] float32 request (TF32 off for matmuls and convolutions)")
    _, per_req32, f32_first = serve(model32, "f32", reqs[:1])
    per_req += per_req32
    if any(p != (8, 4) for p in per_req):
        fail(f"expected +8 window_attn / +4 vit_flash_attn per request, got "
             f"{per_req}")
    for name, a, b in (("dense_prompt", bf16_first[0], f32_first[0]),
                       ("sam_features", bf16_first[1], f32_first[1])):
        rel = float((a - b).norm() / b.norm())
        say(f"[main] bf16 vs f32, request 0, {name}: relative L2 error "
            f"{rel:.3e}")
    agree = float((bf16_first[2] > 0.5).eq(f32_first[2] > 0.5).float().mean())
    say(f"[main] bf16 vs f32, request 0, mask pixel agreement {agree:.4f}")


# ---------------------------------------------------------------------------
# phase 6: automatic mask generation
# ---------------------------------------------------------------------------


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its name (each keeps .launches)."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    return {"window_attn": VB.window_attn,
            "vit_flash_attn": FA.vit_flash_attn,
            **{k.__name__: k for k in D.KERNELS}}


def launch_counts() -> dict:
    return {name: k.launches for name, k in kernel_wrappers().items()}


def reset_counts() -> None:
    for k in kernel_wrappers().values():
        k.launches = 0


def amg_small_reference_check() -> None:
    """A small ViT (hd = 64, padded windows, a global block) with SAM's
    full-width mask decoder, so every kernel takes it: the AMG of one small
    image on the CPU (plain versions) and on the card (kernels), float32,
    from the same weights."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
    from ullsam_tpu_torch.models.sam.sam import Sam
    from ullsam_tpu_torch.ops import layers as L

    cfg = SamConfig(
        vit=ViTConfig(img_size=256, patch_size=16, embed_dim=128, depth=3,
                      num_heads=2, out_chans=256, window_size=14,
                      global_attn_indexes=(1,)),
        prompt_encoder=PromptEncoderConfig(image_embedding_size=(16, 16),
                                           input_image_size=(256, 256)),
        mask_decoder=MaskDecoderConfig())
    cpu = Sam(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(SEED)
    L.init_module_(cpu, gen)
    gpu = Sam(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    image = np.random.default_rng(SEED).integers(0, 256, (200, 240, 3),
                                                 dtype=np.uint8)
    kw = dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, box_nms_thresh=1.0, max_masks=48)
    ref_m, ref = AutomaticMaskGenerator(cfg, cpu, **kw).generate_dense(image)
    before = launch_counts()
    got_m, got = AutomaticMaskGenerator(cfg, gpu, **kw).generate_dense(image)
    torch.cuda.synchronize()
    after = launch_counts()
    if any(after[k] == before[k] for k in after):
        fail(f"small AMG did not launch every kernel: {before} -> {after}")
    if len(got["candidate"]) != len(ref["candidate"]):
        fail(f"small AMG: {len(got['candidate'])} masks on the card, "
             f"{len(ref['candidate'])} on the CPU")
    o_r, o_g = np.argsort(ref["candidate"]), np.argsort(got["candidate"])
    if not np.array_equal(ref["candidate"][o_r], got["candidate"][o_g]):
        fail("small AMG: the card and the CPU kept different candidates")
    d_iou = float(np.abs(ref["iou_preds"][o_r] - got["iou_preds"][o_g]).max())
    d_st = float(np.abs(ref["stability"][o_r] - got["stability"][o_g]).max())
    agree = float((ref_m.numpy()[o_r] == got_m.cpu().numpy()[o_g]).mean())
    say(f"[reference] small AMG ({len(o_r)} masks), CPU plain vs GPU "
        f"kernels: iou max diff {d_iou:.3e}, stability max diff {d_st:.3e},"
        f" mask pixel agreement {agree:.6f}")
    # float32 with TF32 off: summation order only; a pixel may flip where
    # an upscaled logit lies within rounding of the threshold
    if d_iou > 1e-4 or d_st > 1e-4 or agree < 0.999:
        fail("small AMG: GPU kernels disagree with the CPU plain versions")


def amg_main_path() -> None:
    """SAM ViT-B at full width (random weights from the seed), 1024x1024
    uint8 images, a 32x32 point grid in chunks of 256 prompts, at most 256
    masks an image."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import sam_vit_b
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
    from ullsam_tpu_torch.models.sam.sam import Sam
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.tools.main_path import amg_inputs

    cfg = sam_vit_b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model32 = Sam(cfg, device="cuda")
    L.init_module_(model32, gen)
    model16 = Sam(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    model32.to("cpu")  # one model on the card at a time, for its memory
    torch.cuda.empty_cache()
    images = amg_inputs(np.random.default_rng(SEED), 5)
    sweep = dict(points_per_side=32, points_per_batch=256, max_masks=256)
    off = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0,
               box_nms_thresh=1.0)

    def run(generator, image, tag):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, data = generator.generate_dense(image)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()}
        n = len(data["iou_preds"])
        if (masks.dtype != torch.bool or tuple(masks.shape) != (n, 1024, 1024)
                or not np.isfinite(data["iou_preds"]).all()
                or not np.isfinite(data["stability"]).all()):
            fail(f"AMG {tag}: masks {tuple(masks.shape)} {masks.dtype}")
        say(f"[amg] {tag}: {n} masks, latency {ms:.1f} ms (host clock, ends "
            f"in synchronize), launches {d}")
        return ms, d, masks, data

    g16 = AutomaticMaskGenerator(cfg, model16, **sweep, **off)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run(g16, images[0], "bf16 warm image")
    timed = [run(g16, img, f"bf16 image {i}")
             for i, img in enumerate(images[1:4], 1)]
    peak = torch.cuda.max_memory_allocated()
    want = {"window_attn": 8, "vit_flash_attn": 4, "decode_masks": 4,
            "two_way_transformer": 4, "upscale_hypernet_stats": 4,
            "upscale_hypernet": 4}
    for _, d, _, data in timed:
        if d != want:
            fail(f"AMG launches per image {d}, expected {want}")
        if len(data["iou_preds"]) != 256:
            fail(f"deterministic AMG committed {len(data['iou_preds'])} "
                 f"masks, expected 256")
    total_s = sum(t[0] for t in timed) / 1e3
    n_masks = sum(len(t[3]["iou_preds"]) for t in timed)
    say(f"[amg] bf16 deterministic sweep (thresholds and NMS off), 3 timed "
        f"images: {n_masks / total_s:.1f} masks/s, {3 / total_s:.3f} "
        f"images/s, latency {', '.join(f'{t[0]:.1f}' for t in timed)} ms")
    say(f"[amg] bf16: weights {weights / 2**30:.3f} GiB resident, peak "
        f"{peak / 2**30:.3f} GiB (max_memory_allocated), so "
        f"{(peak - weights) / 2**30:.3f} GiB for the sweep")

    _, _, m16, d16 = timed[0]
    model16.to("cpu")
    torch.cuda.empty_cache()
    model32.to("cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, _, m32, d32 = run(AutomaticMaskGenerator(cfg, model32, **sweep, **off),
                         images[1], "f32 image 1 (TF32 off)")
    peak = torch.cuda.max_memory_allocated()
    say(f"[amg] f32: weights {weights / 2**30:.3f} GiB resident, peak "
        f"{peak / 2**30:.3f} GiB, so {(peak - weights) / 2**30:.3f} GiB for "
        f"the sweep")
    both, i16, i32 = np.intersect1d(d16["candidate"], d32["candidate"],
                                    return_indices=True)
    agree = float((m16[torch.from_numpy(i16).cuda()]
                   == m32[torch.from_numpy(i32).cuda()]).float().mean())
    d_iou = float(np.abs(d16["iou_preds"][i16] - d32["iou_preds"][i32]).max())
    say(f"[amg] bf16 vs f32, image 1: {len(both)} of 256 candidates in "
        f"both, on them mask pixel agreement {agree:.4f}, iou max diff "
        f"{d_iou:.3e}")
    del m16, m32
    model32.to("cpu")
    torch.cuda.empty_cache()
    model16.to("cuda")
    upstream = AutomaticMaskGenerator(cfg, model16, **sweep)
    run(upstream, images[4], "bf16 image 4, upstream thresholds 0.88 / 0.95 "
        "/ NMS 0.7 (random weights commit few masks)")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        from ullsam_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"cannot import ullsam_tpu_torch ({e}); run from the repo root")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"[device] {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    try:
        build.build_all()
    except RuntimeError as e:
        fail(str(e))
    say(f"[build] {len(build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, one process per source)")
    for src in build.SOURCES:
        for fn, regs, smem, spills in ptxas_summary(
                build.ptxas_report(src)):
            say(f"[build] {src}: {fn}: {regs} registers, {smem} bytes "
                f"static smem, spills {spills}")

    # f32 means f32 on every path below (cuDNN convolutions default to
    # TF32); the bf16 paths are unaffected by these flags
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("[device] torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    rows = check_kernels(smi)
    rows.update(check_decoder_kernels(smi))
    small_reference_check()
    amg_small_reference_check()
    by_path = {}
    for path, drive in (("interactive", main_path), ("amg", amg_main_path)):
        reset_counts()
        drive()
        by_path[path] = launch_counts()
        say(f"[main] launches on the {path} path: {by_path[path]}")
    launches = {name: sum(c[name] for c in by_path.values()) for name in rows}
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    say(json.dumps({"kernels": list(rows.values())}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
