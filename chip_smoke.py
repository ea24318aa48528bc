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
    CUDA events; the least time the card could take (bound; in float32
    f32-accurate products at their fastest, split TF32 at 495 / 3 TFLOP/s).
    The float32 bodies on the tensor cores in split TF32 (B1, B2, B3, B8,
    B9, B10, B11, B13, B14, B15, B4-B7, the wgmma GEMM's f32 kind) also
    against a float64 evaluation of their plain version: on every output
    within 4x the plain float32 version's own error (B2, B10 and B11 also
    two calls bitwise equal). B4-B7's fused kernels in bf16 and float32
    (B5's two image stages and their token -> image attention, the upscale
    with and without statistics) also alone: time, bound and achieved
    bandwidth.
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
    1 warm and 3 timed images, in float32 1 warm and 3 timed images, and
    one bfloat16 image with the upstream thresholds (0.88 / 0.95 / NMS
    0.7); every chunk launches each fused decoder kernel of its dtype its
    count a chunk (float32 also the GEMM's f32 kind 25 times from the
    token side), none of the other dtype's; each sweep's peak memory and
    its parts.
 7. the segmentation train step: a small uLLSAM trained one f32 step on the
    CPU (plain versions) and on the card (kernels) from the same weights
    and batch, loss and every gradient compared; then the flagship (SAM
    ViT-B + frozen InternLM2-1.8B) at full width in bfloat16 without remat,
    1 warm and 3 timed steps on the batch of
    benchmarks/bench_train_step.py, then from the same starting weights a
    float32 step with remat (B2 8, B9 4), two float32 steps (B1, B3, B8 8,
    B2, B9 4) and two bfloat16 steps with remat, each float32 step timed
    with exact launches; step 1 with remat is held to step 1 without it in
    loss and grad norm (float32: rtol 1e-4 each; bfloat16: 1e-4 and 1e-2).
 8. packed LLM fine-tuning (``--mode sft --pack --max_length 2560``): B10
    and B11 against their plain versions at the path's shapes (phase 3's
    checks); a small uLLSAM whose LLM has head dim 128, one f32 sft step on
    a packed row of S = 2560 (the real B10 dispatch) on the CPU (plain
    versions) and on the card (kernels), loss within 1e-5 relative and
    every gradient within 1e-3 of its max; then the flagship at full width
    in bfloat16 (the LLM, mlp1 and mlp2 train, SAM frozen, remat on), 1 warm
    and 3 timed steps on one packed row of two samples (1124 + 1224 tokens,
    two images), with exact launches per step, and one bfloat16
    interactive segment_prefill with a 2560-token prompt; then the flagship
    again in float32 (the JAX CLI's default parameter dtype), 1 warm and 2
    timed steps with exact launches (B10 48, B11 24 and the f32 kinds of
    its encode), the LLM moving, SAM bit-identical, the peak above weights
    and moments.
 9. caption generation with the int8 weight-only LLM: B12 against its plain
    version at every shape of InternLM2-1.8B's linears on the caption and
    serving paths: decode at 1, 4, 8 and 16 rows, the serving engine's
    prompt segments (M = 128, 256), prefill of the 1152-token prompt at
    batch 1 and 8 (M = 1152, 9216), the tp 2 ranks' own linears at 4 and
    256 rows, bf16 and f32 (phase 3's checks; decode with the
    weight cold in L2; each case launches exactly the B12 kernel that
    ``int8_matmul.w8a16_kernel`` names, by its own count, split over K as
    ``int8_matmul.plan`` says, which the library's own plan must match: the GEMV at one row and for f32 x, the decode body on the
    tensor cores at 2-16 rows in bf16, the wgmma GEMM with an int8 operand
    at the bf16 prefill of the layer linears; a split call bitwise equal
    when called again and when replayed from a CUDA graph); a small uLLSAM
    with its LLM quantized, 16 greedy
    tokens of ``caption_ids`` with an image on the CPU (plain versions) and
    on the card (kernels), tokens identical and each step's logits within
    1e-4 of their max; then the flagship at full width in bfloat16
    (``caption_ids``, 256 new tokens, 1024 image + 64 text tokens padded to
    1152): 1 warm + 1 timed request and a left-padded batch of 8, then with
    ``quantize_llm_int8``, 1 warm + 3 timed and a batch of 8, each with
    prefill and per-step decode times, tokens/s, peak memory and exact
    launches (int8: B12 121 a decode step and in the prefill, each on the
    kernel ``w8a16_kernel`` names at its rows; bf16: none),
    and the int8 prefill against bf16's at batch 1 and 8.
10. SAM ViT-H automatic mask generation: B1, B2, B3 and (bf16) B8 at head
    dim 80 and the opt-in kernels B13 (fused LN + MLP), B14 (global
    attention read from the qkv projection) and B15 (two-phase window
    attention) against their plain versions at ViT-H's shapes (B13-B15 at
    ViT-B's too), bf16 and f32 (phase 3's checks; B3 and B15 share one SDPA
    reading a shape; in bf16 they and B1 run one window core); the wgmma
    GEMM that carries B1's and B13's bf16 products at each product's shape
    (M = 4900; B13's also 4096) against its f32 plain product, one launch
    each by its own count, timed beside F.linear; the same products in
    float32 on its f32 kind (split TF32) against float64, beside F.linear in
    float32 (TF32 off); a small encoder with
    head dim 80 on the CPU
    (plain versions) and on the card (kernels) under each route setting of
    the JAX package's switches (default, ULLSAM_FUSED_VIT_MLP=1,
    ULLSAM_PACKED_GLOBAL=1, ULLSAM_FUSED_VIT_ATTN=0, and that with
    ULLSAM_WINDOW_TWOPHASE=1), f32 within 1e-4 of max|out|, exact launches;
    then ``build_sam("vit_h")`` at full width (random weights from the
    seed) on 1024x1024 images, the deterministic sweep: bf16 1 warm + 3
    timed images with exact launches (B1 28, B2 4, B4-B7 4 an image, the
    fused decoder kernels their count a chunk), 1 warm + 3 timed f32
    images (the fused f32 decoder kernels their count a chunk) with the
    sweep's peak and its parts; the encode
    alone under each route setting (1 warm + 5 timed, exact launches, each
    bf16 embedding against the default route's), and
    one bf16 image with all four switches on (B13 32, B14 4, B15 28). In
    every bf16 request, image and encode the wgmma GEMM launches exactly
    twice per B1 or B13 launch (its qkv / proj, fc1 / fc2), and none in
    f32 (there its f32 kind, as every path checks). Phase 3's checks at head dim 80 also hold B8 and B9 in both
    dtypes at ViT-H training's shapes (25 windows x 16 heads of 80; 16
    heads over 4096 tokens) and B14's backward (its heads through B9).
11. the segmentation train step at SAM ViT-H (``--mode segment
    --sam_variant vit_h``): the small uLLSAM of phase 7 with 2 heads of 80,
    one f32 step CPU (plain) vs card (B1, B3, B8, B2, B9 at head dim 80,
    f32 B8 and B9 included), loss within rtol 1e-4 and every gradient
    within 1e-3 (``grad_gap``); then SAM ViT-H + frozen InternLM2-1.8B at
    full width (random weights from the seed) on phase 7's batch: (a) bf16
    without remat, 1 warm and 3 timed steps with exact launches (B1, B3, B8
    28, B2, B9 4), the trainable tensors moving, the frozen LLM
    bit-identical, the peak above weights and moments; (d) one bf16 step
    under every switch (B15 and B8 28, B13 32, B14 and B9 4); (b) one f32
    step with remat, the JAX CLI's defaults (B2 8, B9 4, the windows plain);
    (c) one f32 step without remat (f32 B8 at head dim 80 in 28 blocks),
    held to (b) in loss and grad norm (rtol 1e-4) and every gradient; (d)
    held to (a)'s step 1 at 3x (a)'s distance from (c), and no less than
    phase 7's bf16 limits (1e-4, 1e-2).
12. serving: (a) a small f32 uLLSAM (the small ViT, a 2-layer LLM with
    the flagship's vocab) through ``serve.engine.GenerationEngine`` with
    its decode chunks as captured CUDA graphs, 6 greedy requests from
    threads into 4 slots (image and text prompts, one in 3 prefill
    segments), each request's tokens equal to batch-1 ``caption_ids``;
    (b) SAM ViT-B + InternLM2-1.8B at full width, the engine at 8 slots,
    max_len 2560, segments of 256, 8 steps a chunk, bf16 then int8: a warm
    round, then 1, 4 and 8 concurrent image caption requests (a 1024x1024
    uint8 image, the template's 1143-token prompt with a stub tokenizer)
    and 8 text-only requests, 128 new tokens each: every request
    completes, first tokens equal batch-1 ``caption_ids``', prefill logits
    at most 2x as far (relative L2) as ``caption_ids``' from an f32 LLM of
    the same weights, B12 121 launches a decode step in int8
    (the graph keys' warm-ups) and none in bf16; tok/s, time to the first
    token, chunk device time (CUDA events) against the worker loop, graphs
    captured and their capture time, the peak above the weights,
    ``phase_stats``; (c) the port's app at full width in bf16 with the
    engine, on a free port, through ``_smoke``'s sequence.
13. the rest of inference (``[rest]`` lines): (a) ``calibrate_amg_weights``
    of a small SAM on the CPU and on the card from the same weights (drawn
    tensors bitwise, probed ones within 1e-4); ``build_sam("vit_b")`` and
    ``build_sam("vit_h")`` calibrated on the card and cast to bf16, the
    production config (0.88 / 0.95 / NMS 0.7, 32x32 points, 256 a chunk, at
    most 256 masks) on 1024x1024 images through ``generate_dense_batch``,
    1 warm and 3 timed: masks committed (at least 8), images/s, the peak,
    exact launches; one f32 image matched to bf16's (mean mask IoU >=
    0.99, at least 0.7 of the smaller set in common); (b) on the
    calibrated ViT-B in bf16, one crop layer (1 warm and 2 timed images;
    each crop its own sweep), the device path against the host stitch at
    crop NMS 1.0 (bitwise), two crop layers on a 768x1000 image (unequal
    edge crops); (c) ``SamPredictor``: one
    ``set_image`` (B1 8, B2 4), point, box and point-plus-mask-input
    predictions timed with no kernel launched, 64 clicks tracking their
    prompts; (d) the ``sam_vitb_full`` golden through B1 and B2 in f32 and
    bf16 at ``tests/test_flagship_parity.py``'s tolerances; (e)
    ``beam_search`` on InternLM2-1.8B, the 1152-token image prompt, 4 beams,
    32 tokens, bf16 then int8: one beam equals greedy ``caption_ids``, the
    beams' log-probability at least greedy's, B12 121 a pass in int8; (f)
    the exported decoder loaded on the card against the eager function.
14. the training and evaluation CLIs (``[cli]`` lines) at full width
    (SAM ViT-B + InternLM2-1.8B, random weights from the seed) on a
    synthetic dataset of 4 1024x1024 PNGs with 3-4 instances each and the
    stub tokenizer: (b) ``python -m ullsam_tpu_torch.train.cli --mode
    segment --grad_accum 2 --instance_matching hungarian --max_steps 8
    --epochs 2`` at the CLI's defaults (f32, remat), each step's loss,
    grad norm and time, exact launches (B2 8 and B9 4 a micro-step, B1 8
    and B2 4 an overlay), micro-step 1 held to a direct ``train/step.py``
    call on the same example from the same weights (loss and grad norm
    rtol 1e-4), and ``--epochs 1`` then ``--epochs 2 --resume`` held to
    the straight run (each step's loss and grad norm rtol 1e-4, every
    final trainable tensor as ``grad_gap`` 1e-3); (c) ``--mode sft --pack
    --max_length 2560 --param_dtype bfloat16 --max_steps 2``, phase 8's
    launches a step (B10 48, B11 24); (d) the eval CLI in the modes seg,
    seg_amg and lm (``--limit 2``) on a reference-named ``.pt`` of (b)'s
    model, every summary value finite, the first image's seg masks bitwise
    equal to direct ``chat.point_segment`` calls.
15. data and tensor parallelism and the native host ops (``[parallel]``
    lines; rank processes are this script run as ``--parallel-rank CASE
    RANK WORLD DIR``, two ranks on ``cuda:0`` over gloo, since NCCL refuses
    two ranks on one device; any rank that exits non-zero fails the
    phase): (1) a world-size-1 NCCL group, the flagship f32 step (no remat)
    through a 1 x 1 mesh bitwise the direct step (metrics, every step-1
    gradient, the weights after step 2); (2) dp 2, one row a rank, against
    one process's step on both rows: loss and grad norm rtol DP_RTOL each
    step, every step-1 gradient as ``grad_gap`` 1e-3, TRAIN_PER_STEP
    launches a step on each rank, the ranks' weights bitwise equal after
    step 2, each rank's peak beside the reckoning; (3) the tp 2 engine at
    full width (8 kv heads, 4 a rank; int8, then bf16; chunks eager under
    gloo), one image and one text request, a warm round then TP_NEW
    tokens: first logits within TP_LOGIT_RTOL (relative L2) of batch-1 tp 1
    ``caption_ids``, tokens equal through the first step whose reference
    top-2 gap is under that of its logits' RMS, B12 launches exact on each
    rank; (4) ``amg_sharded_sweep``, one 1024x1024 image a rank at ViT-B in
    bf16, 32x32 points: every output of each image bitwise its
    single-image sweep, each rank's launches one sweep's; (5) the native
    host ops on this machine's CPU (the library must load) against numpy /
    scipy on the 256 masks of (4)'s first image: RLE and the 8-connected
    labelling bitwise (``remove_small_regions`` on 16 of them), the IoU
    matrix within one float32 ulp, each timed both ways, the IoU's peak
    host memory.
Each path (5-15) runs with every launch counter set to 0 just before it and
read just after; in every request, image and step of paths 5-11 the float32
kinds launch exactly as B1, B3, B13 and B15 ask (float32: two launches of
the GEMM's f32 kind per B1 or B13, one of the f32 window core per B1, B3
or B15, none of gemm.cuh's FMA GEMM from B1 or B13; bfloat16: none of
them). Then the kernels JSON line (every kernel, the wgmma GEMM, its f32
kind and the f32 window core; ``launches``: the sum over the paths;
``launches_by_path``: each path's own count, launches that ran; B12's
``serve_graphs``: the chunks and steps replayed from the serve path's
graphs and B12's launches a decode step in their warm-ups), the
nvidia-smi line, and the final status line.
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
H100_TF32_FLOPS = 495e12   # dense tensor-core TF32 (SXM data sheet)
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
    """(the least time the card can take, what bounds it). In f32 the
    operations are f32-accurate products at their fastest: split TF32, three
    TF32 products for each, 495 / 3 TFLOP/s, above the 67 of the CUDA
    cores."""
    import torch
    peak = (H100_BF16_FLOPS if dtype == torch.bfloat16 else
            max(H100_F32_FLOPS, H100_TF32_FLOPS / 3))
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# B1's and B3's plain versions round where the JAX kernels do (the whole
# row's f32 logits, p normalized and then rounded), as the one bf16 window
# core does
ROUNDING = {n: "; plain at the JAX rounding points"
            for n in ("window_attn", "window_attn_core",
                      "window_attn_core_twophase")}
# B2's and B14's lse (B9's input) against plain, relative to max|lse|
LSE_TOL = 1e-5


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
            lse_note = ""
            if name == "vit_flash_attn":  # B9 reads lse: held to 1e-5
                lse_rel = errs[1] / scales[1]
                ok = ok and lse_rel <= LSE_TOL
                lse_note = f", lse {lse_rel:.3e} (tol {LSE_TOL:.0e})"
            say(f"[kernels] {name} {dname}: max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} (per output, relative to max|plain|;"
                f" tol {tol[dtype]:.0e}{ROUNDING.get(name, '')}){lse_note} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            if name == "vit_flash_attn" and dtype == torch.float32:
                # no atomics in the split-TF32 body: two calls, the same bits
                again = kernel(*args, **kw)
                same = all(torch.equal(a, b) for a, b in zip(outs, again))
                say(f"[kernels] {name} {dname}: two calls bitwise equal "
                    f"{'ok' if same else 'FAIL'}")
                if not same:
                    fail(f"{name} {dname}: two calls differ")
                del again
            f64 = (f64_hold(name, plain, args, outs, refs, "kernels", kw)
                   if dtype == torch.float32 and name in SPLIT_TF32 else {})
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
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     **f64}
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

    # f32: also each float output against a float64 evaluation of the plain
    # version (f64_hold)
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
            if dtype == torch.float32 and name in SPLIT_TF32:
                entry.update(f64_hold(
                    name, lambda *a, **k: decoder_outputs(
                        name, plain(*a, **k))[0], args,
                    decoder_outputs(name, kernel(*args, **kw))[0],
                    decoder_outputs(name, plain(*args, **kw))[0], "kernels",
                    kw))
            if dtype == torch.bfloat16:
                rows[name].update(entry)
            else:
                rows[name]["float32"] = entry
        del cases, args
        torch.cuda.empty_cache()
    rows["decode_masks"]["fused"] = check_fused_decoder_kernels(card)
    return rows


def check_fused_decoder_kernels(card: str) -> dict:
    """The fused kernels inside B4-B7 alone at the AMG chunk, bf16 and
    float32 (names ending in ``_f32``; their agreement with the plain
    chain is B4-B7's, above): each one's time, bound and achieved
    bandwidth."""
    import torch
    from ullsam_tpu_torch.tools.main_path import (AMG_CHUNK,
                                                  fused_decoder_cases)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        for name, (call, flops, nbytes) in fused_decoder_cases(
                gen, dtype=dtype, **AMG_CHUNK).items():
            ms = cuda_time_ms(call, iters=10, warmup=2)
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            say(f"[kernels] fused {name} {dname}: {ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.1f} GB/s, "
                f"{flops / ms / 1e9:.1f} TFLOP/s (card: {card})")
            out[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                         "gb_per_s": nbytes / ms / 1e6}
        torch.cuda.empty_cache()
    return out


TRAIN_KERNELS = (
    ("window_attn_core", "ullsam_tpu_torch/csrc/window_attn.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:1033"),
    ("window_attn_core_bwd", "ullsam_tpu_torch/csrc/window_attn_bwd.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:1194"),
    ("vit_flash_attn_bwd", "ullsam_tpu_torch/csrc/vit_flash_bwd.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:812"))


def _sdpa_ms(q, k, v, bias, backward: bool, **kw) -> float:
    """The library yardstick: scaled_dot_product_attention with the bias
    (or boolean mask) materialized; with ``backward`` the time of its
    backward alone, on one retained graph (every float input, a float bias
    included, requiring grad). ``kw`` goes to the call (``enable_gqa``)."""
    import torch
    import torch.nn.functional as F
    ins = [t.detach().requires_grad_(backward and t.is_floating_point())
           for t in (q, k, v, bias)]

    def fwd():
        return F.scaled_dot_product_attention(ins[0], ins[1], ins[2],
                                              attn_mask=ins[3], **kw)
    # 20 timed calls after 3 warm-ups: two readings of one function agree
    # within a few percent (5 after 1 differed by 46% between two rows)
    if not backward:
        return cuda_time_ms(fwd, iters=20, warmup=3)
    out, g = fwd(), torch.randn_like(q)
    req = [t for t in ins if t.requires_grad]
    # timed directly: (forward + backward) less forward moved 20-28%
    # between calls
    return cuda_time_ms(lambda: torch.autograd.grad(out, req, g,
                                                    retain_graph=True),
                        iters=20, warmup=3)


# the float32 bodies that take their products in split TF32: each output's
# error against a float64 evaluation of the plain version is held to
# F64_RATIO x the plain float32 version's own (the forward kernels at every
# shape a phase runs them)
FWD_TF32 = ("window_attn", "window_attn_core", "window_attn_core_twophase",
            "ln_mlp", "decode_masks", "two_way_transformer",
            "upscale_hypernet_stats", "upscale_hypernet", "vit_flash_attn",
            "vit_flash_attn_packed")
SPLIT_TF32 = ("window_attn_core_bwd", "vit_flash_attn_bwd",
              "llm_flash_attn", "llm_flash_attn_bwd") + FWD_TF32
F64_RATIO = 4.0


def f64_hold(name: str, plain, args, got, ref, pre: str, kw=None) -> dict:
    """Kernel ``got`` and plain float32 ``ref`` (outputs, or tuples of
    them) against ``plain`` on ``args`` (and ``kw``) in float64: max|x -
    ref64| / max|ref64| of each output; fails where the kernel's exceeds
    F64_RATIO x plain's. Returns the worst of each, for the kernels line."""
    import torch

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    def double(t):  # a weights dict too (not its TF32 planes)
        if isinstance(t, dict):
            return {k: double(v) for k, v in t.items()
                    if not k.endswith(("_hi", "_lo"))}
        return (t.double() if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t)
    got, ref = tup(got), tup(ref)
    ref64 = tup(plain(*(double(t) for t in args), **(kw or {})))
    worst = [0.0, 0.0]
    bad = []
    for i, (a, b, r) in enumerate(zip(got, ref, ref64)):
        scale = float(r.abs().max())
        ek = float((a.double() - r).abs().max()) / scale
        ep = float((b.double() - r).abs().max()) / scale
        worst = [max(worst[0], ek), max(worst[1], ep)]
        if ek > F64_RATIO * ep:
            bad.append((i, ek, ep))
    del ref64
    torch.cuda.empty_cache()
    say(f"[{pre}] {name} float32 against float64: kernel max_rel_err="
        f"{worst[0]:.3e}, plain f32 {worst[1]:.3e} (worst output; each "
        f"output held to {F64_RATIO:g}x plain's) "
        f"{'FAIL ' + str(bad) if bad else 'ok'}")
    if bad:
        fail(f"{name} float32 is less accurate than {F64_RATIO:g}x its plain "
             f"version against float64: {bad}")
    return {"err_vs_f64": worst[0], "plain_err_vs_f64": worst[1]}


def check_train_kernels(card: str) -> dict:
    """B3, B8 and B9 against their plain versions at the train step's
    shapes (ViT-B's 25 windows x 12 heads of 14x14 tokens; its global
    blocks, 12 heads over 4096 tokens), in bf16 and f32, every output
    compared. The library yardstick is scaled_dot_product_attention with
    the materialized bias: forward for B3, backward for B8 and B9."""
    import torch
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    from ullsam_tpu_torch.tools.main_path import (FLASH_BWD, WINDOW_CORE,
                                                  vit_flash_bwd_case,
                                                  window_core_case)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {name: {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces}
            for name, source, replaces in TRAIN_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        fwd, bwd, wflops, wbytes = window_core_case(dtype, gen,
                                                    **WINDOW_CORE)
        fargs, fflops, fbytes = vit_flash_bwd_case(dtype, gen, **FLASH_BWD)
        Bw, ws, nh = (WINDOW_CORE[k] for k in ("Bw", "ws", "nh"))
        n = ws * ws
        for name, kernel, plain, args, flops, nbytes in (
                ("window_attn_core", WA.window_attn_core,
                 WA.window_attn_core_plain, fwd, wflops["fwd"],
                 wbytes["fwd"]),
                ("window_attn_core_bwd", WA.window_attn_core_bwd,
                 WA.window_attn_core_bwd_plain, bwd, wflops["bwd"],
                 wbytes["bwd"]),
                ("vit_flash_attn_bwd", FA.vit_flash_attn_bwd,
                 FA.vit_flash_attn_bwd_plain, fargs, fflops, fbytes)):
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            outs = got if isinstance(got, tuple) else (got,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(outs, refs)]
            rel = max(e / max(float(b.float().abs().max()), 1e-30)
                      for e, b in zip(errs, refs))
            ok = (rel <= tol[dtype]
                  and all(bool(torch.isfinite(a).all()) for a in outs))
            say(f"[kernels] {name} {dname}: max_abs_err={max(errs):.3e} "
                f"max_rel_err={rel:.3e} over {len(outs)} output(s) "
                f"(relative to max|plain|; tol {tol[dtype]:.0e}"
                f"{ROUNDING.get(name, '')}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            f64 = (f64_hold(name, plain, args, outs, refs, "kernels")
                   if dtype == torch.float32 and name in SPLIT_TF32 else {})
            del got, ref, outs, refs
            big = name == "vit_flash_attn_bwd"
            ms = cuda_time_ms(lambda: kernel(*args), iters=5 if big else 20)
            plain_ms = cuda_time_ms(lambda: plain(*args), iters=2,
                                    warmup=1)
            if big:
                q, k, v, rh, rw = args[:5]
                BH, N, _ = q.shape
                bias = (rh.float()[..., :, None] + rw.float()[..., None, :]
                        ).reshape(1, BH, N, N).to(dtype)
                lib_ms = _sdpa_ms(q[None], k[None], v[None], bias, True)
            else:
                from ullsam_tpu_torch.ops.kernels.window_attention import (
                    _rel_terms, _split_heads)
                q, k, v = (t.to(dtype) for t in _split_heads(args[0], n, 64))
                rel_h, rel_w = _rel_terms(q.float(), args[1].float(),
                                          args[2].float(), ws, ws)
                bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(
                    -2).to(dtype)
                lib_ms = _sdpa_ms(q, k, v, bias,
                                  name == "window_attn_core_bwd")
            del bias
            torch.cuda.empty_cache()
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            say(f"[kernels] {name} {dname}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; data-sheet peaks at 700 W, card: "
                f"{card}), {flops / ms / 1e9:.1f} TFLOP/s")
            entry = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     **f64}
            if dtype == torch.bfloat16:
                rows[name].update(entry)
            else:
                rows[name]["float32"] = entry
        del fwd, bwd, fargs, args
        torch.cuda.empty_cache()
    return rows


LLM_KERNELS = (
    ("llm_flash_attn", "ullsam_tpu_torch/csrc/llm_flash_attn.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:395"),
    ("llm_flash_attn_bwd", "ullsam_tpu_torch/csrc/llm_flash_bwd.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:622"))


def check_llm_kernels(card: str) -> dict:
    """B10 and B11 against their plain versions at the packed sft path's
    shape (one row of S = 2560, 16 query heads of 128 over 8 kv heads, the
    segment boundaries at 1124 and 2348), in bf16 and f32, every output
    compared (lse on the rows that have a valid key); in f32 (split TF32)
    each output also against a float64 evaluation of the plain version
    (``f64_hold``) and two calls bitwise equal. The bound counts the
    valid same-segment pairs these segment ids give; the causal half the
    TPU kernel's tiles cover is printed beside it. The library yardstick is
    scaled_dot_product_attention with the boolean block-diagonal causal
    mask materialized and enable_gqa: forward for B10, backward for B11."""
    import torch
    from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
    from ullsam_tpu_torch.tools.main_path import LLM_FLASH, llm_flash_case

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {name: {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces}
            for name, source, replaces in LLM_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        fwd, bwd, kw, flops, nbytes = llm_flash_case(dtype, gen, **LLM_FLASH)
        q, k, v, seg, _ = fwd
        S = q.shape[1]
        mask = ((seg[0][:, None] == seg[0][None, :])
                & torch.ones(S, S, dtype=torch.bool, device="cuda").tril())
        for name, kernel, plain, args, direction in (
                ("llm_flash_attn", LF.llm_flash_attn,
                 LF.llm_flash_attn_plain, fwd, "fwd"),
                ("llm_flash_attn_bwd", LF.llm_flash_attn_bwd,
                 LF.llm_flash_attn_bwd_plain, bwd, "bwd")):
            got, ref = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            f64 = {}
            if dtype == torch.float32:
                # split TF32 against float64; the same bits every call
                f64 = f64_hold(name, plain, args, got, ref, "kernels", kw)
                again = kernel(*args, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                say(f"[kernels] {name} float32: two calls bitwise equal: "
                    f"{same}")
                if not same:
                    fail(f"{name} float32 differs between two calls")
                del again
            if name == "llm_flash_attn":
                live = ref[1] > LF.NEG_INF / 2
                got = (got[0], got[1][live])
                ref = (ref[0], ref[1][live])
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, ref)]
            rel = max(e / max(float(b.float().abs().max()), 1e-30)
                      for e, b in zip(errs, ref))
            ok = (rel <= tol[dtype]
                  and all(bool(torch.isfinite(a).all()) for a in got))
            say(f"[kernels] {name} {dname}: max_abs_err={max(errs):.3e} "
                f"max_rel_err={rel:.3e} over {len(got)} output(s) "
                f"(relative to max|plain|; tol {tol[dtype]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            del got, ref
            ms = cuda_time_ms(lambda: kernel(*args, **kw), iters=20)
            plain_ms = cuda_time_ms(lambda: plain(*args, **kw), iters=3,
                                    warmup=1)
            lib_ms = _sdpa_ms(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), mask[None, None],
                              direction == "bwd", enable_gqa=True)
            torch.cuda.empty_cache()
            fl = flops[direction]
            b_ms, b_by = bound_ms(fl, nbytes[direction], dtype)
            c_ms, _ = bound_ms(flops[direction + "_causal"],
                               nbytes[direction], dtype)
            say(f"[kernels] {name} {dname}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {fl / 1e9:.2f} GFLOP of same-segment"
                f" pairs, {nbytes[direction] / 1e6:.1f} MB; over the causal "
                f"half, {flops[direction + '_causal'] / 1e9:.2f} GFLOP, "
                f"{c_ms:.4f} ms; data-sheet peaks at 700 W, card: {card}), "
                f"{fl / ms / 1e9:.1f} TFLOP/s of the same-segment work")
            entry = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     **f64}
            if dtype == torch.bfloat16:
                rows[name].update(entry)
            else:
                rows[name]["float32"] = entry
        del fwd, bwd, args, mask
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


def small_config(hd: int = 64):
    """A small uLLSAM that every ViT kernel takes: 2 heads of ``hd`` (64, or
    ViT-H's 80), a padded 16x16 grid in 14x14 windows, one global block; a
    2-layer LLM."""
    from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    return FusionConfig(
        sam=SamConfig(
            vit=ViTConfig(img_size=256, patch_size=16, embed_dim=2 * hd,
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


def small_reference_check() -> None:
    """A small uLLSAM (hd = 64 so both kernels take it; a padded window
    grid and a global block) from one set of weights: plain versions on the
    CPU against the kernels on the card, in float32."""
    import numpy as np
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.tools.main_path import request_inputs

    cfg = small_config()
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
            g0 = c_counts()
            ms, dense, feats, mask, probs, iou = run_request(model, cfg, inp)
            d1 = VB.window_attn.launches - b1
            d2 = FA.vit_flash_attn.launches - b2
            # in bf16 each B1 launch runs its two products on the wgmma
            # GEMM; in f32 on its f32 kind (neither bf16 GEMM), and B1's
            # core on the f32 window core
            f32 = next(model.parameters()).dtype == torch.float32
            dg = check_f32_kinds(f"{name} request {i}",
                                 {"window_attn": d1}, g0, f32)
            want_g = {"gemm_sm90": 0 if f32 else 2 * d1, "gemm_mma": 0}
            if {k: dg[k] for k in want_g} != want_g:
                fail(f"{name} request {i}: GEMM launches {dg}, expected "
                     f"{want_g}")
            per_req.append((d1, d2))
            lat.append(ms)
            if i == 0:
                first = (dense.float(), feats.float(), probs)
            say(f"[main] {name} request {i}: {inp[2].shape[1]} click(s), "
                f"latency {ms:.1f} ms (host clock, ends in synchronize), "
                f"launches window_attn +{d1} vit_flash_attn +{d2} "
                f"gemm_sm90 +{dg['gemm_sm90']}, gemm_sm90_f32 "
                f"+{dg['gemm_sm90_f32']}, window_core_f32 "
                f"+{dg['window_core_f32']}, "
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
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    return {"window_attn": VB.window_attn,
            "vit_flash_attn": FA.vit_flash_attn,
            **{k.__name__: k for k in D.KERNELS},
            "window_attn_core": WA.window_attn_core,
            "window_attn_core_bwd": WA.window_attn_core_bwd,
            "vit_flash_attn_bwd": FA.vit_flash_attn_bwd,
            "llm_flash_attn": LF.llm_flash_attn,
            "llm_flash_attn_bwd": LF.llm_flash_attn_bwd,
            "w8a16_matmul": Q.w8a16_matmul,
            "ln_mlp": VB.ln_mlp,
            "vit_flash_attn_packed": FA.vit_flash_attn_packed,
            "window_attn_core_twophase": WA.window_attn_core_twophase}


def launch_counts() -> dict:
    return {name: k.launches for name, k in kernel_wrappers().items()}


def c_counts() -> dict:
    """Launches of the kernels counted in C where each launches: the two
    bf16 GEMM kernels (the wgmma one, which carries B1's and B13's bf16
    products, and gemm.cuh's mma.sync one: B4-B7, B12 and any other
    shape), the wgmma GEMM's f32 kind (B1's and B13's f32 products, split
    TF32), gemm.cuh's FMA GEMM launched by B1 or B13 (other f32 shapes) and
    the f32 window core (B1's, B3's and B15's in f32)."""
    from ullsam_tpu_torch.ops.kernels import gemm as G
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    return {"gemm_sm90": G.gemm_sm90.launches,
            "gemm_mma": G.gemm_mma.launches,
            "gemm_sm90_f32": G.gemm_sm90_f32.launches,
            "gemm_fma": G.gemm_fma.launches,
            "window_core_f32": WA.window_core_f32.launches}


def check_f32_kinds(tag: str, d: dict, c0: dict, f32: bool) -> dict:
    """The C-counted kernels launched since ``c0`` (``c_counts``), held to
    the wrapper launches ``d`` of the same span: in float32 two launches
    of the GEMM's f32 kind per B1 or B13 launch and one of the f32 window
    core per B1, B3 or B15 launch, none of the FMA GEMM from B1 or B13 (at
    SAM's widths every f32 product takes the f32 kind: the old CUDA-core
    paths cannot run unseen); in bfloat16 none of the three. Returns the
    difference."""
    dc = {k: v - c0[k] for k, v in c_counts().items()}
    gemms = d.get("window_attn", 0) + d.get("ln_mlp", 0)
    cores = (d.get("window_attn", 0) + d.get("window_attn_core", 0)
             + d.get("window_attn_core_twophase", 0))
    want = {"gemm_sm90_f32": 2 * gemms if f32 else 0,
            "window_core_f32": cores if f32 else 0, "gemm_fma": 0}
    got = {k: dc[k] for k in want}
    if got != want:
        fail(f"{tag}: f32 kernel launches {got}, expected {want} for "
             f"wrapper launches {d}")
    return dc


def fused_counts() -> dict:
    """Launches of each fused kernel of B4-B7 (``decoder.FUSED_KERNELS``,
    bf16 and float32) and of the wgmma GEMM's f32 kind by B4-B7's token
    side (``decoder.decoder_gemm_f32``, counted in C)."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    return {**{k: c.launches for k, c in D.FUSED_KERNELS.items()},
            "decoder_gemm_f32": D.decoder_gemm_f32.launches}


# the fused kernels an AMG chunk launches (one B4 call of 3 masks): bf16;
# float32, with the token side's and the hypernet MLPs' first two layers'
# products on the GEMM's f32 kind (19 + 2 x 3)
FUSED_PER_CHUNK = {"image_stage1": 1, "image_stage2": 1, "t2i_part": 2,
                   "upscale_unit_stats": 1}
FUSED_PER_CHUNK_F32 = {"image_stage1_f32": 1, "image_stage2_f32": 1,
                       "t2i_part_f32": 2, "t2i_f32": 1,
                       "upscale_unit_stats_f32": 1, "decoder_gemm_f32": 25}


def check_fused(tag: str, f0: dict, chunks: int, bf16: bool) -> dict:
    """The fused kernels launched since f0: FUSED_PER_CHUNK a chunk on the
    bf16 route, FUSED_PER_CHUNK_F32 on the float32 one."""
    d = {k: v - f0[k] for k, v in fused_counts().items() if v != f0[k]}
    want = {k: v * chunks for k, v in (
        FUSED_PER_CHUNK if bf16 else FUSED_PER_CHUNK_F32).items()}
    if d != want:
        fail(f"{tag}: fused decoder kernels {d}, expected {want}")
    return d


def b12_counts() -> dict:
    """Launches of each of B12's kernels (``int8_matmul.KERNELS``)."""
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    return {k: c.launches for k, c in Q.kernel_launches.items()}


def reset_counts() -> None:
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.ops.kernels import gemm as G
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    for k in (*kernel_wrappers().values(), G.gemm_sm90, G.gemm_mma,
              G.gemm_sm90_f32, G.gemm_fma, WA.window_core_f32,
              *D.FUSED_KERNELS.values(), D.decoder_gemm_f32, D.split_tf32):
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
    train_only = {name for name, _, _ in TRAIN_KERNELS + LLM_KERNELS
                  + (W8A16_KERNEL,) + VIT_H_KERNELS}
    if any(after[k] == before[k] for k in after if k not in train_only):
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


def sweep_peak_parts(model, cfg, image) -> str:
    """The parts of the AMG sweep's peak device memory (at the model's
    dtype): each step's
    peak above what was held when it started, for the encode, one chunk's
    B4 call (256 prompts) and the post-process of the 256 kept masks
    (``amg._upscale_threshold`` to 1024 x 1024), and the size of the
    candidates' low-res logits the sweep keeps between its chunks."""
    import torch
    from ullsam_tpu_torch.inference import amg as A
    from ullsam_tpu_torch.models.sam import sam as S

    def peak(fn):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - held) / 2**30

    dtype = next(model.parameters()).dtype
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    with torch.no_grad():
        x = A.bilinear_resize_nhwc(torch.from_numpy(image)[None].cuda(),
                                   1024, 1024)
        emb, p_enc = peak(lambda: S.encode_image(
            model.image_encoder, S.preprocess(x, cfg).to(dtype)))
        shared = S.shared_image(model.prompt_encoder, model.mask_decoder,
                                emb)
        pts = torch.rand(256, 1, 2, generator=gen, device="cuda") * 1024
        labels = torch.ones((256, 1), dtype=torch.int64, device="cuda")
        out, p_dec = peak(lambda: S.decode_masks_stats(
            model.prompt_encoder, model.mask_decoder, emb,
            points=(pts, labels), multimask_output=True,
            stability_offset=1.0, mask_threshold=cfg.mask_threshold,
            shared=shared))
        low = out[0]
        sel = low.reshape(-1, *low.shape[-2:])[:256]
        _, p_up = peak(lambda: A._upscale_threshold(cfg, sel, (1024, 1024),
                                                    (1024, 1024)))
    cand = 4 * low.numel() * low.element_size() / 2**30
    return (f"encode {p_enc:.3f} GiB, one B4 chunk {p_dec:.3f} GiB, the "
            f"256 kept masks' post-process {p_up:.3f} GiB, candidates "
            f"kept between chunks {cand:.3f} GiB")


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
        f0 = fused_counts()
        c0 = c_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, data = generator.generate_dense(image)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
        df = check_fused(f"AMG {tag}", f0, d.get("decode_masks", 0),
                         "f32" not in tag)
        check_f32_kinds(f"AMG {tag}", d, c0, "f32" in tag)
        n = len(data["iou_preds"])
        if (masks.dtype != torch.bool or tuple(masks.shape) != (n, 1024, 1024)
                or not np.isfinite(data["iou_preds"]).all()
                or not np.isfinite(data["stability"]).all()):
            fail(f"AMG {tag}: masks {tuple(masks.shape)} {masks.dtype}")
        say(f"[amg] {tag}: {n} masks, latency {ms:.1f} ms (host clock, ends "
            f"in synchronize), launches {d}, fused decoder kernels {df}")
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
        f"{(peak - weights) / 2**30:.3f} GiB for the sweep; its parts: "
        f"{sweep_peak_parts(model16, cfg, images[1])}")

    _, _, m16, d16 = timed[0]
    model16.to("cpu")
    torch.cuda.empty_cache()
    model32.to("cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g32 = AutomaticMaskGenerator(cfg, model32, **sweep, **off)
    run(g32, images[0], "f32 warm image (TF32 off)")
    timed32 = [run(g32, img, f"f32 image {i} (TF32 off)")
               for i, img in enumerate(images[1:4], 1)]
    peak = torch.cuda.max_memory_allocated()
    for _, d, _, data in timed32:
        if d != want or len(data["iou_preds"]) != 256:
            fail(f"AMG f32 launches per image {d}, expected {want}, "
                 f"{len(data['iou_preds'])} masks")
    _, _, m32, d32 = timed32[0]
    total_s = sum(t[0] for t in timed32) / 1e3
    say(f"[amg] f32 deterministic sweep, 3 timed images: "
        f"{768 / total_s:.1f} masks/s, latency "
        f"{', '.join(f'{t[0]:.1f}' for t in timed32)} ms")
    say(f"[amg] f32: weights {weights / 2**30:.3f} GiB resident, peak "
        f"{peak / 2**30:.3f} GiB, so {(peak - weights) / 2**30:.3f} GiB for "
        f"the sweep; its parts: {sweep_peak_parts(model32, cfg, images[1])}")
    del timed32
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


# ---------------------------------------------------------------------------
# phase 7: the segmentation train step
# ---------------------------------------------------------------------------

TRAIN_PER_STEP = {"window_attn": 8, "window_attn_core": 8,
                  "window_attn_core_bwd": 8, "vit_flash_attn": 4,
                  "vit_flash_attn_bwd": 4}
# a step with remat at ViT-B or ViT-H: the windows plain, as the JAX package
# runs them in XLA under remat (image_encoder.py:376-403); B2 forward and
# recompute, B9 once in each of the 4 global blocks
TRAIN_REMAT = {"vit_flash_attn": 8, "vit_flash_attn_bwd": 4}


def grad_gap(ref: dict, got: dict):
    """(worst, name): the largest max|got - ref| of a gradient tensor over
    its own max|ref|, that scale floored at 1e-3 of the largest |ref|
    anywhere (so a tensor whose gradient is rounding noise, such as an
    attention k-projection bias, is held to 1e-6 of that at a 1e-3 limit)."""
    top = max(float(g.abs().max()) for g in ref.values())
    worst, worst_name = 0.0, ""
    for n, g in ref.items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        err = float((got[n] - g).abs().max()) / scale
        if err > worst:
            worst, worst_name = err, n
    return worst, worst_name


def train_small_reference_check(hd: int = 64) -> None:
    """One f32 train step of the small uLLSAM (2 heads of ``hd``: 64, or
    ViT-H's 80) on the CPU (plain versions) and on the card (B1, B3, B8,
    B2, B9, float32 B8 and B9 at that head dim) from the same weights and
    batch:
    the loss within rtol 1e-4 and each trainable parameter's gradient
    within 1e-3 of the largest |gradient| of that tensor (f32 with TF32
    off: summation order only), except that tensors whose gradient is
    rounding noise (the attention k-projection biases: exactly zero, the
    softmax being shift-invariant) are held to 1e-6 of the largest
    gradient anywhere."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import train_batch
    from ullsam_tpu_torch.train import step as S

    cfg = small_config(hd)
    tcfg = S.TrainConfig(total_steps=100, remat=False)
    cpu = F.build_ullsam(cfg, device="cpu", seed=SEED)
    gpu = F.ULLSAM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = train_batch(cfg, np.random.default_rng(SEED), n_inst=2,
                        text_len=8)
    res = []
    for model in (cpu, gpu):
        opt = S.make_trainable_optimizer(model, tcfg)
        before = launch_counts()
        m = S.make_train_step(cfg, tcfg, model, opt)(batch)
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in launch_counts().items() if v -
             before[k]}
        grads = {n: p.grad.detach().cpu() for n, p in zip(opt.names,
                                                          opt.params)
                 if p.grad is not None}
        res.append((m, grads, d))
    (m_c, g_c, d_c), (m_g, g_g, d_g) = res
    if d_c or any(not d_g.get(k) for k in TRAIN_PER_STEP):
        fail(f"small train step launches: CPU {d_c}, card {d_g}")
    rel_loss = abs(float(m_g["loss"]) - float(m_c["loss"])) / abs(
        float(m_c["loss"]))
    worst, worst_name = grad_gap(g_c, g_g)
    say(f"[train] small uLLSAM (2 heads of {hd}), one f32 step, CPU plain "
        f"vs card kernels: "
        f"loss {float(m_c['loss']):.6f} vs {float(m_g['loss']):.6f} (rel "
        f"{rel_loss:.2e}), grad_norm {float(m_c['grad_norm']):.6f} vs "
        f"{float(m_g['grad_norm']):.6f}; {len(g_c)} gradient tensors, worst "
        f"{worst:.2e} of max|grad| ({worst_name}); card launches {d_g}")
    if rel_loss > 1e-4 or worst > 1e-3 or set(g_c) != set(g_g):
        fail(f"small train step (hd {hd}): the card and the CPU disagree")


def _step_launches(step, batch, f32: bool, tag: str):
    """(metrics as floats, host-clock ms ending in synchronize, launches)
    of one train step; fails on a non-finite metric or where the f32 kinds
    launch otherwise than its B1 / B3 / B13 / B15 launches ask
    (``check_f32_kinds``; ``f32``: the step's dtype)."""
    import numpy as np
    import torch
    before = launch_counts()
    c0 = c_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    d = {k: v - before[k] for k, v in launch_counts().items()
         if v - before[k]}
    if not all(np.isfinite(list(m.values()))):
        fail(f"train step: non-finite metrics {m}")
    check_f32_kinds(f"train step, {tag}", d, c0, f32)
    return m, ms, d


def train_bf16_steps(cfg, what: str, per_step: dict, pre: str):
    """The flagship at ``cfg`` built from the seed (an f32 model, kept on
    the host after), then in bfloat16 parameters and moments without remat:
    1 warm and 3 timed steps on the flagship batch, each timed one with
    exactly ``per_step`` launches; the trainable tensors move and the
    frozen LLM stays bit-identical; the peak above weights and moments.
    Returns (the f32 model, the device-resident batch, the metrics of steps
    1 and 2). ``pre`` prefixes every line."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import train_batch
    from ullsam_tpu_torch.train import step as S

    t0 = time.perf_counter()
    model32 = F.build_ullsam(cfg, device="cuda", seed=SEED)
    model16 = F.ULLSAM(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    model32.to("cpu")
    torch.cuda.empty_cache()
    batch = train_batch(cfg, np.random.default_rng(SEED))
    tcfg = S.TrainConfig(total_steps=100, remat=False)
    llm = model16.fusion.language_model
    frozen = [p.detach().to("cpu", copy=True) for p in llm.parameters()]
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    opt = S.make_trainable_optimizer(model16, tcfg)
    moments = torch.cuda.memory_allocated() - weights
    n_train = sum(p.numel() for p in opt.params)
    n_all = sum(p.numel() for p in model16.parameters())
    say(f"[{pre}] flagship bf16: {n_all / 1e9:.3f} B params, "
        f"{n_train / 1e6:.1f} M trainable, weights {weights / 2**30:.3f} "
        f"GiB, moments {moments / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    step = S.make_train_step(cfg, tcfg, model16, opt)
    batch = S.batch_on(model16, batch)  # device-resident, as a loader's

    def run(tag):
        m, ms, d = _step_launches(step, batch, False, f"{pre} bf16 {tag}")
        say(f"[{pre}] bf16 {tag}: {ms:.1f} ms (host clock, ends in "
            f"synchronize), loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, iou {m['iou']:.4f}, launches {d}")
        return ms, m, d

    torch.cuda.reset_peak_memory_stats()
    _, first, _ = run("step 1 (warm, lr 0)")
    snap = [p.detach().clone() for p in opt.params]
    timed = [run(f"step {i}") for i in (2, 3, 4)]
    peak = torch.cuda.max_memory_allocated()
    for _, _, d in timed:
        if d != per_step:
            fail(f"{pre} launches per step {d}, expected {per_step}")
    moved = sum(not torch.equal(a, p) for a, p in zip(snap, opt.params))
    same = all(torch.equal(a, p.detach().cpu())
               for a, p in zip(frozen, llm.parameters()))
    say(f"[{pre}] bf16: {moved} of {len(snap)} trainable tensors moved "
        f"over steps 2-4; frozen LLM weights bit-identical: {same}")
    if not moved or not same:
        fail(f"{pre}: trainable weights did not move or frozen ones did")
    lat = [t[0] for t in timed]
    say(f"[{pre}] bf16 flagship step ({what}, b=1, 1088 tokens, 4 "
        f"instances x 2 points, 1024x1024 masks, remat off): "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms, mean {sum(lat) / 3:.1f} "
        f"ms; peak {peak / 2**30:.3f} GiB, so "
        f"{(peak - weights - moments) / 2**30:.3f} GiB above weights and "
        f"moments")
    return model32, batch, first, timed[0][1]


def train_steps(cfg, batch, model, tc, tag: str, n: int, refs, pre: str,
                want=None):
    """Steps 1 (lr 0, so the weights stay as they were) to ``n`` of a fresh
    optimizer on ``model``, each printed beside refs[i - 1] (the metrics of
    the bf16 step of its number) with its peak above the step's start; with
    ``want``, each step launches exactly that. Returns (the metrics of step
    1, its gradients)."""
    import torch
    from ullsam_tpu_torch.train import step as S
    opt = S.make_trainable_optimizer(model, tc)
    st = S.make_train_step(cfg, tc, model, opt)
    out = None
    for i in range(1, n + 1):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m, ms, d = _step_launches(
            st, batch, next(model.parameters()).dtype == torch.float32,
            f"{pre} {tag} step {i}")
        ref = refs[i - 1]
        say(f"[{pre}] {tag} step {i}: {ms:.1f} ms, loss {m['loss']:.6f}"
            f" ({m['loss'] - ref['loss']:+.2e} vs bf16 step {i}), "
            f"grad_norm {m['grad_norm']:.6f} "
            f"({m['grad_norm'] - ref['grad_norm']:+.2e}), peak "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} "
            f"GiB above the step's start, launches {d}")
        if want is not None and d != want:
            fail(f"{pre} {tag} step {i}: launches {d}, expected {want}")
        out = out or (m, {name: p.grad.detach().clone()
                          for name, p in zip(opt.names, opt.params)
                          if p.grad is not None})
    return out


def hold(got, ref, rtols, what: str, pre: str, grads: bool = False) -> None:
    """Fail unless ``got``'s loss and grad norm are within ``rtols`` (loss,
    grad norm) of ``ref``'s, relative, and, with ``grads``, each gradient
    tensor within 1e-3 as in ``grad_gap``."""
    errs = [abs(got[0][k] - ref[0][k]) / abs(ref[0][k])
            for k in ("loss", "grad_norm")]
    msg = (f"[{pre}] {what}, step 1: loss rel {errs[0]:.2e} (rtol "
           f"{rtols[0]:.3g}), grad_norm rel {errs[1]:.2e} (rtol "
           f"{rtols[1]:.3g})")
    bad = any(e > t for e, t in zip(errs, rtols))
    if grads:
        worst, name = grad_gap(ref[1], got[1])
        msg += (f"; {len(ref[1])} gradient tensors, worst {worst:.2e} "
                f"of max|grad| ({name}; tol 1e-3)")
        bad = bad or worst > 1e-3 or set(got[1]) != set(ref[1])
    say(msg)
    if bad:
        fail(f"{pre}: {what} disagree at step 1")


def train_main_path() -> None:
    """SAM ViT-B + InternLM2-1.8B at full width (random weights from the
    seed), bfloat16 parameters and moments, remat off: 1 warm and 3 timed
    steps on the flagship batch; then, from the same starting weights, a
    float32 step with remat, two float32 steps and two bfloat16 steps with
    remat, step 1 with remat held to step 1 without it (``hold``)."""
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.train import step as S

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    model32, batch, first, second = train_bf16_steps(
        cfg, "SAM ViT-B + InternLM2-1.8B", TRAIN_PER_STEP, "train")
    tcfg = S.TrainConfig(total_steps=100, remat=False)
    remat = S.TrainConfig(total_steps=100, remat=True)
    refs = [first, second]
    # all from the starting weights (the f32 model's remat step has lr 0;
    # its step 2 without remat moves its own weights, last)
    model16 = F.ULLSAM(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    model32.to("cuda")
    f32_remat = train_steps(cfg, batch, model32, remat,
                            "f32 (TF32 off) with remat", 1, refs, "train",
                            want=TRAIN_REMAT)
    f32 = train_steps(cfg, batch, model32, tcfg, "f32 (TF32 off)", 2, refs,
                      "train", want=TRAIN_PER_STEP)
    # remat runs the windowed blocks through B1's plain version and the
    # global blocks' B2 twice: in f32 only the summation order differs
    hold(f32_remat, f32, (1e-4, 1e-4), "f32 remat vs no remat", "train",
         grads=True)
    del model32, f32_remat, f32
    torch.cuda.empty_cache()
    # in bf16 the plain version rounds as B1 does but flips roundings where
    # the two sum in another order; the bf16 step's own distance from the
    # f32 step (printed above: about 3e-6 in loss, 4e-3 in grad norm) is
    # the scale of that noise
    hold(train_steps(cfg, batch, model16, remat, "bf16 with remat", 2, refs,
                     "train"), (first, None), (1e-4, 1e-2),
         "bf16 remat vs no remat", "train")


# ---------------------------------------------------------------------------
# phase 8: packed LLM fine-tuning
# ---------------------------------------------------------------------------

PACKED_PER_STEP = {"llm_flash_attn": 48, "llm_flash_attn_bwd": 24,
                   "window_attn": 8, "vit_flash_attn": 4}


def packed_small_reference_check() -> None:
    """One f32 sft step of a small uLLSAM whose LLM has head dim 128 (hidden
    256, 2 heads over 1 kv head, 2 layers) on one packed row of S = 2560
    (two samples of 1124 and 1224 tokens, two images), so the LLM dispatches
    to B10 / B11 as the flagship does: the CPU (plain versions) against the
    card (kernels) from the same weights, the loss within 1e-5 relative and
    every gradient tensor as ``grad_gap`` holds it, within 1e-3 (f32 with
    TF32 off: summation order only)."""
    import dataclasses
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import InternLM2Config
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import (SFT_TRAIN,
                                                  packed_train_batch)
    from ullsam_tpu_torch.train import step as S

    cfg = dataclasses.replace(small_config(), llm=InternLM2Config(
        vocab_size=128, hidden_size=256, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1))
    tcfg = S.TrainConfig(total_steps=100, **SFT_TRAIN)
    cpu = F.build_ullsam(cfg, device="cpu", seed=SEED)
    gpu = F.ULLSAM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = packed_train_batch(cfg, np.random.default_rng(SEED))
    res = []
    for model in (cpu, gpu):
        opt = S.make_trainable_optimizer(model, tcfg)
        before = launch_counts()
        t = time.perf_counter()
        m = S.make_train_step(cfg, tcfg, model, opt)(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items() if v -
             before[k]}
        grads = {n: p.grad.detach().cpu() for n, p in zip(opt.names,
                                                          opt.params)
                 if p.grad is not None}
        res.append((m, grads, d, ms))
    (m_c, g_c, d_c, ms_c), (m_g, g_g, d_g, ms_g) = res
    want = {"llm_flash_attn": 4, "llm_flash_attn_bwd": 2, "window_attn": 2,
            "vit_flash_attn": 1}
    if d_c or d_g != want:
        fail(f"small packed step launches: CPU {d_c}, card {d_g}, expected "
             f"{want} on the card")
    rel_loss = abs(float(m_g["loss"]) - float(m_c["loss"])) / abs(
        float(m_c["loss"]))
    worst, worst_name = grad_gap(g_c, g_g)
    say(f"[packed] small uLLSAM (LLM head dim 128), one f32 sft step on a "
        f"packed row of 2560, CPU plain vs card kernels: loss "
        f"{float(m_c['loss']):.6f} vs {float(m_g['loss']):.6f} (rel "
        f"{rel_loss:.2e}, tol 1e-5), grad_norm {float(m_c['grad_norm']):.6f} "
        f"vs {float(m_g['grad_norm']):.6f}; {len(g_c)} gradient tensors, "
        f"worst {worst:.2e} of max|grad| ({worst_name}; tol 1e-3); CPU "
        f"{ms_c:.0f} ms, card {ms_g:.0f} ms; card launches {d_g}")
    if rel_loss > 1e-5 or worst > 1e-3 or set(g_c) != set(g_g):
        fail("small packed step: the card and the CPU disagree")


def packed_steps(cfg, dtype, timed: int):
    """The flagship at ``cfg`` built from the seed in ``dtype`` parameters
    and moments, the sft settings (the LLM, mlp1 and mlp2 train, SAM
    frozen, remat on): 1 warm and ``timed`` timed steps on one packed row
    (S = 2560: 1124 + 1224 tokens, two 1024x1024 images), each timed one
    with exactly PACKED_PER_STEP launches and the f32 kinds its encode asks
    (``check_f32_kinds``); the LLM tensors move and the frozen SAM weights
    stay bit-identical; the peak above weights and moments. Returns the
    model (its optimizer freed)."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import (SFT_TRAIN,
                                                  packed_train_batch)
    from ullsam_tpu_torch.train import step as S

    dn = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    f32 = dtype == torch.float32
    t0 = time.perf_counter()
    model = F.build_ullsam(cfg, device="cuda", dtype=dtype, seed=SEED)
    tcfg = S.TrainConfig(total_steps=100, **SFT_TRAIN)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    opt = S.make_trainable_optimizer(model, tcfg)
    moments = torch.cuda.memory_allocated() - weights
    trained = set(opt.names)
    frozen = {n: p.detach().to("cpu", copy=True)
              for n, p in model.named_parameters() if n not in trained}
    n_train = sum(p.numel() for p in opt.params)
    n_all = sum(p.numel() for p in model.parameters())
    say(f"[packed] flagship {dn} sft: {n_train / 1e9:.3f} B trainable "
        f"(LLM, mlp1, mlp2) of {n_all / 1e9:.3f} B, weights "
        f"{weights / 2**30:.3f} GiB, moments {moments / 2**30:.3f} GiB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    step = S.make_train_step(cfg, tcfg, model, opt)
    batch = S.batch_on(model, packed_train_batch(
        cfg, np.random.default_rng(SEED)))

    def run(tag):
        before = launch_counts()
        c0 = c_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v - before[k]}
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(list(vals.values()))):
            fail(f"packed {dn} {tag}: non-finite metrics {vals}")
        dc = check_f32_kinds(f"packed {dn} {tag}", d, c0, f32)
        kinds = {k: v for k, v in dc.items() if v}
        say(f"[packed] {dn} {tag}: {ms:.1f} ms (host clock, ends in "
            f"synchronize), loss {vals['loss']:.6f}, grad_norm "
            f"{vals['grad_norm']:.6f}, launches {d}"
            + (f", C-counted {kinds}" if kinds else ""))
        return ms, d

    torch.cuda.reset_peak_memory_stats()
    run("step 1 (warm, lr 0)")
    snap = [p.detach().clone() for p in opt.params]
    runs = [run(f"step {i}") for i in range(2, 2 + timed)]
    peak = torch.cuda.max_memory_allocated()
    for _, d in runs:
        if d != PACKED_PER_STEP:
            fail(f"packed {dn} launches per step {d}, expected "
                 f"{PACKED_PER_STEP}")
    llm = [i for i, n in enumerate(opt.names)
           if n.startswith("fusion.language_model.")]
    moved = sum(not torch.equal(snap[i], opt.params[i]) for i in llm)
    same = all(torch.equal(p.detach().cpu(), frozen[n])
               for n, p in model.named_parameters() if n not in trained)
    say(f"[packed] {dn}: {moved} of {len(llm)} LLM tensors moved over steps "
        f"2-{1 + timed}; frozen SAM weights bit-identical: {same}")
    if not moved or not same:
        fail(f"packed {dn}: the LLM weights did not move or frozen ones did")
    lat = [r[0] for r in runs]
    say(f"[packed] {dn} flagship sft step (SAM ViT-B + InternLM2-1.8B, one "
        f"packed row of 2560 tokens, two images, remat on): "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms, mean "
        f"{sum(lat) / timed:.1f} ms, {2560 * timed / sum(lat) * 1e3:.0f} "
        f"tokens/s; peak {peak / 2**30:.3f} GiB (max_memory_allocated), so "
        f"{(peak - weights - moments) / 2**30:.3f} GiB above weights and "
        f"moments")
    del opt, step, snap, frozen, batch
    torch.cuda.empty_cache()
    return model


def packed_main_path() -> None:
    """SAM ViT-B + InternLM2-1.8B at full width (random weights from the
    seed), the sft settings (``packed_steps``): bfloat16 parameters and
    moments, 1 warm and 3 timed steps, then one bfloat16 segment_prefill
    with a 2560-token prompt; then from the seed again in float32 (the JAX
    CLI's default ``--param_dtype``), 1 warm and 2 timed steps. One model
    is resident at a time."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.tools.main_path import request_inputs

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    model = packed_steps(cfg, torch.bfloat16, 3)

    n_img = cfg.num_image_token
    pixels, ids, _, _ = request_inputs(cfg, np.random.default_rng(SEED), 1,
                                       text_len=2560 - n_img)
    before = launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense, feats = chat.segment_prefill(model, cfg, pixels, ids)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    d = {k: v - before[k] for k, v in launch_counts().items()
         if v - before[k]}
    g = cfg.feature_hw
    for x in (dense, feats):
        if (tuple(x.shape) != (1, g, g, cfg.vit_feature_dim)
                or not bool(torch.isfinite(x).all())):
            fail(f"long prefill: output {tuple(x.shape)} not finite or "
                 f"wrong shape")
    want = {"llm_flash_attn": 24, "window_attn": 8, "vit_flash_attn": 4}
    say(f"[packed] bf16 segment_prefill, {ids.shape[1]}-token prompt: "
        f"{ms:.1f} ms (host clock, ends in synchronize), launches {d}")
    if d != want:
        fail(f"long prefill launches {d}, expected {want}")
    del model, dense, feats
    torch.cuda.empty_cache()
    packed_steps(cfg, torch.float32, 2)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: caption generation with the int8 weight-only LLM
# ---------------------------------------------------------------------------

W8A16_KERNEL = ("w8a16_matmul", "ullsam_tpu_torch/csrc/w8a16_matmul.cu",
                "ullsam_tpu/ops/pallas/int8_matmul.py:29")
# B12 launches of one decode step of InternLM2-1.8B, and of one prefill:
# wqkv, wo, w1, w3, w2 in each of 24 layers, and the vocab head
B12_PER_PASS = 5 * 24 + 1
# (N, K, launches a pass) of those linears, and on a rank of the tp 2
# engine (wqkv, w1 / w3 split by rows, wo, w2 by columns, the head whole)
B12_LINEARS = ((4096, 2048, 24), (2048, 2048, 24), (8192, 2048, 48),
               (2048, 8192, 24), (92553, 2048, 1))
B12_TP2_LINEARS = ((2048, 2048, 24), (2048, 1024, 24), (4096, 2048, 48),
                   (2048, 4096, 24), (92553, 2048, 1))


def b12_pass(M: int, linears=B12_LINEARS, times: int = 1,
             dtype=None) -> dict:
    """{B12 kernel: launches} of ``times`` passes of x in ``dtype`` (bf16
    by default) at M rows over ``linears`` on this card
    (``int8_matmul.w8a16_kernel``; f32 prefill's pre-pass counted too:
    ``call_launches``)."""
    import torch
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for N, K, n in linears:
        for k, c in Q.call_launches(
                Q.w8a16_kernel(M, N, K, dtype or torch.bfloat16,
                               sms)).items():
            out[k] = out.get(k, 0) + c * n * times
    return out


def _plus_counts(*ds: dict) -> dict:
    out = {}
    for d in ds:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def _copies(t, min_bytes: int = 128 << 20) -> list:
    """``t`` and clones of it, together at least ``min_bytes``: a launch
    that cycles through them finds its weight outside the 50 MB L2, as each
    decode step does (it streams 1.7 GB of weights between two uses of
    one)."""
    n = max(1, -(-min_bytes // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def _graph_ms(call, weights: list, reps: int = 3) -> float:
    """Device time of one ``call(w)``, w cycling through ``weights``: the
    launches are captured in a CUDA graph and replayed, so the time is the
    card's and not the host's (a decode-size launch takes the host longer
    to issue than the card to run)."""
    import torch
    n = max(20, 2 * len(weights))
    for w in weights[:2]:
        call(w)  # warm-up: build, caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            call(weights[i % len(weights)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def check_w8a16_kernel(card: str) -> dict:
    """B12 against its plain version on the card at every case of
    ``tools/main_path.w8a16_cases`` (each of InternLM2-1.8B's linears at
    the decode batches 1, 4, 8 and 16, at the serving engine's prompt
    segments, M = 128 and 256, and at the prefill of the caption prompt, M
    = 1152 and 9216: the head's last N tile is ragged there; the tp 2
    ranks' own linears at 4 and 256 rows), x in bf16
    and f32 (x split exactly into three bf16 planes on the tensor cores at
    2-16 rows and at the layer linears' prefill; the GEMV at one row, the
    FMA GEMM for the head's prefill): the f32 output within 1e-5 of
    max|plain| (int8 -> x's type is exact, only the summation order
    differs), f32 x also against float64 (``f64_hold``: at most F64_RATIO
    times the plain f32 version's error), and with a bias and the cast
    to x's type (the main path's variant) within one step of that type at
    max|plain| (bf16: 2^(e - 8) for max|plain| in [2^(e-1), 2^e), up to 2^-7
    of it: two f32 sums that differ in their last bits can round to
    neighbouring values; f32: 1e-5 of max|plain|). The library's own plan
    (``int8_matmul.c_plan``: kernel, K splits, the decode body's warps a
    tile) must be the Python mirror's; a call that splits K (the decode
    body's warps on a tile's K and its blocks, the wgmma GEMM's units at the
    engine's segments) must give a bitwise equal result when called again
    and when replayed from a CUDA graph. Kernel
    and library times are device times (``_graph_ms``): at decode with a
    cold L2 (the weight cycles through copies), at the layer linears' bf16
    prefill (tens of microseconds a launch, less than the host takes to
    launch one) on one weight, f32 x's too; the vocab head's prefill runs
    for milliseconds, so CUDA events around 3 calls time it. Each case
    launches the kernel ``int8_matmul.w8a16_kernel`` names, twice. The
    library yardstick is F.linear on the dequantized weight in x's type (2
    bytes a weight in bf16): no PyTorch call computes W8A16 with f32
    scales, and the port never calls it."""
    import math

    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.tools.main_path import (W8A16_DECODE_M, W8A16_TP2_M,
                                                  w8a16_case, w8a16_cases)

    name, source, replaces = W8A16_KERNEL
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "cases": []}
    decode_m = set(W8A16_DECODE_M) | set(m for m in W8A16_TP2_M if m <= 16)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for M, N, K in w8a16_cases():
            (x, q, s), _, flops, nbytes = w8a16_case(dtype, gen, M, N, K)
            bias = torch.randn(N, generator=gen, device="cuda")
            kname, nsplit, warps = Q.plan(M, N, K, dtype, sms)
            if (Q.c_plan(M, N, K, dtype) != (kname, nsplit, warps)
                    or Q.c_workspace(M, N, K, dtype)
                    != Q.workspace(M, N, K, dtype, sms)):
                fail(f"{name} {dname} M={M} N={N} K={K}: the library plans "
                     f"{Q.c_plan(M, N, K, dtype)} with workspace "
                     f"{Q.c_workspace(M, N, K, dtype)}, the mirror "
                     f"{(kname, nsplit, warps)}, "
                     f"{Q.workspace(M, N, K, dtype, sms)}")
            before = {k: c.launches for k, c in Q.kernel_launches.items()}
            got, ref = Q.w8a16_matmul(x, q, s), Q.w8a16_matmul_plain(x, q, s)
            got_c = Q.w8a16_matmul(x, q, s, bias, out_dtype=dtype)
            ref_c = Q.w8a16_matmul_plain(x, q, s, bias, dtype)
            torch.cuda.synchronize()
            ran = {k: c.launches - before[k]
                   for k, c in Q.kernel_launches.items()
                   if c.launches != before[k]}
            if ran != {k: 2 * c for k, c in Q.call_launches(kname).items()}:
                fail(f"{name} {dname} M={M} N={N} K={K}: launched {ran}, "
                     f"expected {kname} twice")
            same = ""
            if nsplit > 1 or warps > 1:  # again, and from a graph's replay
                with Q.uncounted():
                    again = Q.w8a16_matmul(x, q, s, bias, out_dtype=dtype)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        replay = Q.w8a16_matmul(x, q, s, bias,
                                                out_dtype=dtype)
                    replay.zero_()
                    graph.replay()
                    torch.cuda.synchronize()
                eq = torch.equal(again, got_c) and torch.equal(replay, got_c)
                same = (f"; {nsplit} splits, {warps} warps a tile: again "
                        f"and a graph replay bitwise equal {eq}")
                if not eq:
                    fail(f"{name} {dname} M={M} N={N} K={K}: a split call "
                         f"is not bitwise repeatable")
                del again, replay, graph
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            top = float(ref_c.float().abs().max())
            rel_c = float((got_c.float() - ref_c.float()).abs().max()) / top
            step = (2.0 ** (math.frexp(top)[1] - 8) / top
                    if dtype == torch.bfloat16 else 1e-5)
            ok = (bool(torch.isfinite(got).all()) and rel <= 1e-5
                  and rel_c <= step)
            say(f"[kernels] {name} {dname} M={M} N={N} K={K} ({kname}): "
                f"max_abs_err="
                f"{err:.3e} max_rel_err={rel:.3e} (f32 output, relative to "
                f"max|plain|; tol 1e-05), with bias and cast to {dname} "
                f"{rel_c:.3e} (tol {step:.3e}){same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} M={M} N={N} K={K} disagrees with its "
                     f"plain version")
            hold = {}
            if dtype == torch.float32:
                hold = f64_hold(
                    f"{name} M={M} N={N} K={K} ({kname})",
                    lambda x, q, s: torch.matmul(x, q.to(x.dtype).t()) * s,
                    (x, q, s), got, ref, "kernels")
            del got, ref, got_c, ref_c
            w_lib = (q.to(dtype) * s[:, None]).to(dtype)
            if M in decode_m:
                ms = _graph_ms(lambda w: Q.w8a16_matmul(x, w, s), _copies(q))
                lib_ms = _graph_ms(lambda w: F.linear(x, w), _copies(w_lib))
            elif kname in ("w8a16_sm90", "w8a16_sm90_f32"):
                # tens of microseconds a launch (f32 x at 9216 rows: ms)
                ms = _graph_ms(lambda w: Q.w8a16_matmul(x, w, s), [q])
                lib_ms = _graph_ms(lambda w: F.linear(x, w), [w_lib])
            else:  # the head, or f32 x: milliseconds a launch
                ms = cuda_time_ms(lambda: Q.w8a16_matmul(x, q, s), iters=3,
                                  warmup=1)
                lib_ms = cuda_time_ms(lambda: F.linear(x, w_lib), iters=3,
                                      warmup=1)
            plain_ms = cuda_time_ms(lambda: Q.w8a16_matmul_plain(x, q, s),
                                    iters=3, warmup=1)
            del w_lib
            torch.cuda.empty_cache()
            # f32 x times the int8 W (exact in bf16) is three exact bf16
            # products (x split in three): its least time is theirs
            x3 = dtype == torch.float32
            b_ms, b_by = bound_ms(flops * (3 if x3 else 1), nbytes,
                                  torch.bfloat16)
            say(f"[kernels] {name} {dname} M={M} N={N} K={K} ({kname}, "
                f"{nsplit} splits, {warps} warps a tile): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (F.linear "
                f"on the dequantized {dname} weight) {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.3f} GFLOP"
                f"{', as three bf16 products' if x3 else ''}"
                f", {nbytes / 1e6:.2f} MB; data-sheet peaks at 700 W, card: "
                f"{card}), {nbytes / ms / 1e6:.1f} GB/s, "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     **hold}
            row["cases"].append({"dtype": dname, "M": M, "N": N, "K": K,
                                 "kernel": kname, "splits": nsplit,
                                 "warps": warps, **entry})
            # the row's own numbers: w1, a layer's largest linear, at batch 1;
            # its other entries w1 at a serve decode step's 8 rows (the
            # tensor-core body), w2 at a 256-row prompt segment (the wgmma
            # GEMM split over K) and w1 at the batch-1 caption prompt, in
            # bf16 and (f32_*) f32
            if (M, N, K) == (1, 8192, 2048):
                if dtype == torch.bfloat16:
                    row.update(entry)
                else:
                    row["float32"] = entry
            for key, case in (("decode8", (8, 8192, 2048)),
                              ("segment256", (256, 2048, 8192)),
                              ("prefill", (1152, 8192, 2048))):
                if (M, N, K) == case:
                    key = key if dtype == torch.bfloat16 else f"f32_{key}"
                    row[key] = {"kernel": kname, "splits": nsplit, **entry}
            del x, q, s, bias
        torch.cuda.empty_cache()
    return {name: row}


def caption_small_reference_check() -> None:
    """The small uLLSAM (LLM hidden 64, MLP 128, 2 layers; ViT hd 64) with
    an image, its LLM quantized on each device, f32: ``caption_ids`` of two
    left-padded prompts, 16 greedy tokens, on the CPU (plain versions) and
    on the card (B12 in every int8 linear, B1 and B2 in the encoder): the
    int8 weights and the tokens identical, each step's logits within 1e-4
    of their max."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.models.ullsam import fusion as F

    cfg = small_config()
    cpu = F.build_ullsam(cfg, device="cpu", seed=SEED)
    gpu = F.ULLSAM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    for m in (cpu, gpu):
        quantize_llm_int8(m.fusion.language_model)
    same_q = all(torch.equal(a, b.cpu()) for (n, a), b in zip(
        cpu.state_dict().items(), gpu.state_dict().values())
        if n.endswith("qweight"))
    rng = np.random.default_rng(SEED)
    rows = [[1, 11] + [cfg.img_context_token_id] * cfg.num_image_token
            + rng.integers(3, 100, n).tolist() for n in (6, 13)]
    ids, mask = chat.left_pad(rows, cfg.llm.pad_token_id)
    pixels = rng.standard_normal((1, 256, 256, 3)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=16, eos_token_id=-1)
    res = []
    for m in (cpu, gpu):
        logits = []
        before = launch_counts()
        toks, lens = chat.caption_ids(
            m, cfg, pixels, ids, mask, gen,
            step_hook=lambda i, lg: logits.append(lg.float().cpu()))
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v - before[k]}
        res.append((toks.cpu(), logits, d))
    (t_c, l_c, d_c), (t_g, l_g, d_g) = res
    want = {"w8a16_matmul": 11 * 16, "window_attn": 2, "vit_flash_attn": 1}
    worst = max(float((b - a).abs().max() / a.abs().max())
                for a, b in zip(l_c, l_g))
    say(f"[caption] small uLLSAM, int8 LLM, f32, 2 prompts of {ids.shape[1]} "
        f"tokens, 16 greedy tokens, CPU plain vs card kernels: int8 weights "
        f"equal {same_q}, tokens equal {torch.equal(t_c, t_g)}, logits worst "
        f"{worst:.2e} of max (tol 1e-4); card launches {d_g}")
    if d_c or d_g != want:
        fail(f"small caption launches: CPU {d_c}, card {d_g}, expected "
             f"{want} on the card")
    if not same_q or not torch.equal(t_c, t_g) or worst > 1e-4:
        fail("small caption: the card and the CPU disagree")


def caption_main_path() -> None:
    """SAM ViT-B + InternLM2-1.8B at full width (random bf16 weights from
    the seed), ``caption_ids`` with ``GenerationConfig(max_new_tokens=256)``
    on one 1024x1024 image and 1024 <IMG_CONTEXT> + 64 text tokens
    (left-padded to 1152): bf16, 1 warm + 1 timed request at batch 1 and
    one left-padded batch-8 request; then the LLM quantized in place
    (``quantize_llm_int8``), 1 warm + 3 timed requests at batch 1 and one
    batch-8 request. Exact launches: int8, B12 121 a decode step and 121 in
    the prefill (with the encoder's B1 8 and B2 4, once a request); bf16,
    no B12."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import (CAPTION_BATCH_TEXT,
                                                  caption_inputs)

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    t0 = time.perf_counter()
    model = F.build_ullsam(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    torch.cuda.synchronize()
    say(f"[caption] flagship bf16 built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    one = caption_inputs(cfg, rng)
    eight = caption_inputs(cfg, rng, CAPTION_BATCH_TEXT)
    gen = GenerationConfig(max_new_tokens=256)
    encode = {"window_attn": 8, "vit_flash_attn": 4}

    def run(tag, inputs, b12):
        """One request: prefill (image encode, embeddings, LLM prefill and
        the first token) and decode times from the step hook, launches of
        the prefill and of every decode step, held to the exact counts."""
        marks = []
        before = launch_counts()
        b12_before = b12_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        toks, lens = chat.caption_ids(
            model, cfg, *inputs, gen=gen,
            step_hook=lambda i, lg: marks.append((time.perf_counter(),
                                                  launch_counts(),
                                                  b12_counts())))
        end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - base
        counts = [before] + [c for _, c, _ in marks]
        diffs = [{k: b[k] - a[k] for k in b if b[k] != a[k]}
                 for a, b in zip(counts, counts[1:])]
        # which B12 kernel each launch took: in the prefill the layer
        # linears the wgmma GEMM (M = B x 1152), the ragged head the
        # mma.sync GEMM; at every decode step (M = B) the GEMV at batch 1,
        # the decode body on the tensor cores at batch 8
        k12 = [b12_before] + [c for _, _, c in marks]
        d12 = [{k: b[k] - a[k] for k in b if b[k] != a[k]}
               for a, b in zip(k12, k12[1:])]
        B = inputs[1].shape[0]
        want12 = (b12_pass(B * inputs[1].shape[1]),
                  b12_pass(B)) if b12 else ({}, {})
        if d12[0] != want12[0] or any(d != want12[1] for d in d12[1:]):
            fail(f"caption {tag}: B12 kernels prefill {d12[0]} (expected "
                 f"{want12[0]}), decode steps {d12[1:3]} (expected "
                 f"{want12[1]})")
        want_pre = dict(encode, **({"w8a16_matmul": B12_PER_PASS} if b12
                                   else {}))
        want_dec = {"w8a16_matmul": B12_PER_PASS} if b12 else {}
        bad = [d for d in diffs[1:] if d != want_dec]
        n_tok = int(lens.sum())
        steps = len(marks) - 1
        pre_ms = (marks[0][0] - t) * 1e3
        dec_ms = (marks[-1][0] - marks[0][0]) * 1e3 / max(steps, 1)
        total = end - t
        if toks.shape != (B, 256) or not bool((lens >= 1).all()):
            fail(f"caption {tag}: tokens {tuple(toks.shape)}")
        say(f"[caption] {tag}: batch {B}, {inputs[1].shape[1]}-token "
            f"left-padded prompts ({int(inputs[2].sum())} valid tokens), "
            f"prefill {pre_ms:.1f} ms (image encode + embeddings + LLM "
            f"prefill + first token), {steps} decode steps at "
            f"{dec_ms:.3f} ms a step, {n_tok} tokens generated (through the "
            f"first EOS), {n_tok / total:.1f} tok/s over the request "
            f"({total * 1e3:.1f} ms; {B * 1e3 / dec_ms:.1f} tok/s in decode),"
            f" peak {peak / 2**30:.3f} GiB above the weights; launches "
            f"prefill {diffs[0]}, decode step {diffs[1] if steps else {}}; "
            f"B12 kernels prefill {d12[0]}, decode step "
            f"{d12[1] if steps else {}}")
        if diffs[0] != want_pre or bad:
            fail(f"caption {tag}: launches prefill {diffs[0]} (expected "
                 f"{want_pre}), decode steps off {want_dec}: {bad[:2]}")
        return toks.cpu(), lens.cpu(), pre_ms, dec_ms

    w16 = torch.cuda.memory_allocated()
    run("bf16 warm request", one, False)
    t16, _, pre16, _ = run("bf16 request", one, False)
    pre16_8 = run("bf16 batch-8 request", eight, False)[2]
    lm = model.fusion.language_model
    torch.cuda.synchronize()
    quantize_llm_int8(lm)
    torch.cuda.empty_cache()
    w8 = torch.cuda.memory_allocated()
    say(f"[caption] weights {w16 / 2**30:.3f} GiB in bf16, {w8 / 2**30:.3f} "
        f"GiB with the LLM's linears int8 (memory_allocated)")
    run("int8 warm request", one, True)
    timed = [run(f"int8 request {i}", one, True) for i in (1, 2, 3)]
    pre8_8 = run("int8 batch-8 request", eight, True)[2]
    t8 = timed[0][0]
    pre8 = min(r[2] for r in timed)
    say(f"[caption] prefill (image encode + LLM prefill + first token), "
        f"int8 against bf16: batch 1 {pre8:.1f} against {pre16:.1f} ms "
        f"({pre8 / pre16:.3f}x; int8 the least of 3), batch 8 "
        f"{pre8_8:.1f} against {pre16_8:.1f} ms ({pre8_8 / pre16_8:.3f}x)")
    agree = int((t8 == t16).sum())
    say(f"[caption] int8 vs bf16, batch 1: {agree} of 256 greedy tokens "
        f"agree position by position (printed only)")
    say(f"[caption] int8 batch 1: prefill "
        f"{', '.join(f'{r[2]:.1f}' for r in timed)} ms; decode "
        f"{', '.join(f'{r[3]:.3f}' for r in timed)} ms a step")
    del model, lm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: serving (the continuous-batching caption engine and the app)
# ---------------------------------------------------------------------------

# the chat template's special tokens at their ids in the deployed vocab
SPECIAL_IDS = {"<|im_end|>": 92542, "<|im_start|>": 92543, "<img>": 92544,
               "</img>": 92545, "<IMG_CONTEXT>": 92546}
SERVE_NEW = 128          # new tokens of a full-width serve request
SERVE_TIMEOUT = 300.0    # seconds a request may take
SERVE_IMAGE_Q = "Describe the image in detail."
SERVE_TEXT_QS = tuple(f"Question {i}: which stain marks structure {i}?"
                      + " Answer briefly." * i for i in range(8))
# the serve path's graphs: replayed chunks and steps, and B12's launches a
# decode step counted in the keys' eager warm-ups
SERVE = {}
# the prefill-logits gate: the engine (256-token segments into a bf16
# cache) and batch-1 ``caption_ids`` (one left-padded prefill) round the
# same function, an f32 LLM holding the same weights, in another order; the
# engine's relative L2 from that f32 reference may be at most this multiple
# of ``caption_ids``' own
SERVE_LOGIT_RATIO = 2.0
# the full-width engines of the serve phase: (tag, model dtype, quant, its
# rounds of (request kind, concurrent requests), whether an admission's
# device time is taken); the last is the app's --dtype float32 --quant int8,
# one round of 8 image requests to keep the script's time
SERVE_ROUNDS = (("image", 1), ("image", 4), ("image", 8), ("text", 8))
SERVE_ENGINES = (("bf16", "bfloat16", None, SERVE_ROUNDS, False),
                 ("int8", "bfloat16", "int8", SERVE_ROUNDS, False),
                 ("f32 int8", "float32", "int8", (("image", 8),), True))


class StubTokenizer:
    """A stand-in for the InternLM2 tokenizer (its asset is not in the
    repository): one id per character (3 + code point mod 90000) after a
    BOS of 1, the template's special tokens at their real ids, pad 2."""
    pad_token_id, bos_token_id = 2, 1

    def __init__(self):
        self._pat = re.compile("|".join(re.escape(t) for t in SPECIAL_IDS))

    def encode(self, text, add_bos=True):
        ids, pos = ([1] if add_bos else []), 0
        for m in self._pat.finditer(text):
            ids += [3 + ord(c) % 90000 for c in text[pos:m.start()]]
            ids.append(SPECIAL_IDS[m.group()])
            pos = m.end()
        return ids + [3 + ord(c) % 90000 for c in text[pos:]]

    def encode_batch(self, texts, pad_side="left", add_bos=None):
        enc = [self.encode(t) for t in texts]
        n = max(map(len, enc))
        return ([[2] * (n - len(e)) + e for e in enc],
                [[0] * (n - len(e)) + [1] * len(e) for e in enc])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) for i in ids
                       if 3 <= i < 90003 and not 0xD800 <= i - 3 < 0xE000)

    def convert_tokens_to_ids(self, token):
        return SPECIAL_IDS[token]


def _restore_counts(saved: dict) -> None:
    """Set each kernel wrapper's count back to ``saved``
    (``launch_counts``): reference runs do not count on a path."""
    for name, k in kernel_wrappers().items():
        k.launches = saved[name]


def _serve_refs(model, cfg, prompts: dict, new: int,
                cache_dtype=None) -> dict:
    """Batch-1 ``caption_ids`` of each prompt (name -> (ids, pixels)),
    left-padded to a multiple of 128, its cache in ``cache_dtype`` (default
    the model's): name -> (tokens through the first EOS, prefill logits
    f32 [V]); not counted on the path."""
    import torch
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.ullsam import chat
    saved = launch_counts()
    gen = GenerationConfig(max_new_tokens=new,
                           eos_token_id=SPECIAL_IDS["<|im_end|>"],
                           pad_token_id=StubTokenizer.pad_token_id)
    refs = {}
    for name, (ids, pixels) in prompts.items():
        first = []
        toks, lens = chat.caption_ids(
            model, cfg, pixels,
            *chat.left_pad([ids], gen.pad_token_id), gen,
            step_hook=lambda i, lg: first.append(lg[0].float()) if i == 0
            else None, cache_dtype=cache_dtype)
        refs[name] = (toks[0, :int(lens[0])].tolist(), first[0])
    torch.cuda.synchronize()
    _restore_counts(saved)
    return refs


def _graph_replays(eng) -> tuple:
    """(chunks replayed, decode steps replayed) from captured graphs."""
    chunks = sum(eng.replays.values())
    steps = sum(n * key[0] for key, n in eng.replays.items())
    return chunks, steps


def _rel_l2(a, b) -> float:
    """Relative L2 of ``a`` from the reference ``b``, in f32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _f32_llm(lm, quantized=None):
    """An f32 copy of the bf16 LLM ``lm`` holding the weights a path
    serves: with ``quantized`` (the engine's int8 copy of ``lm``) each of
    its int8 linears' weights dequantized, q * scale, in f32."""
    import copy

    import torch
    from ullsam_tpu_torch.models.internlm2.quant import QUANT_LAYER_LINEARS
    ref = copy.deepcopy(lm).float()
    if quantized is not None:
        pairs = [(ref.output, quantized.output)]
        for rl, ql in zip(ref.model.layers, quantized.model.layers):
            for path in QUANT_LAYER_LINEARS:
                owner, name = path.split(".")
                pairs.append((getattr(getattr(rl, owner), name),
                              getattr(getattr(ql, owner), name)))
        with torch.no_grad():
            for lin, q in pairs:
                lin.weight.copy_(q.qweight.float() * q.qscale[:, None])
    return ref


def _engine_refs(model, cfg, eng, scaled: dict, quant) -> tuple:
    """(refs, exact) for ``eng``'s rounds: batch-1 ``caption_ids`` of each
    prompt on the LLM the engine serves (its int8 copy in int8) with a
    cache of the engine's dtype, SERVE_NEW tokens, and the first logits of
    an f32 LLM holding the same weights (the dequantized ones in int8), its
    cache f32; ``model``'s LLM is put back after."""
    lm = model.fusion.language_model
    model.fusion.language_model = eng.lm
    try:
        refs = _serve_refs(model, cfg, scaled, SERVE_NEW, eng.cache_dtype)
        model.fusion.language_model = _f32_llm(lm, eng.lm if quant else None)
        exact = _serve_refs(model, cfg, scaled, 1)
    finally:
        model.fusion.language_model = lm
    return refs, exact


def serve_small_reference_check() -> None:
    """(a) A small f32 uLLSAM (the small ViT, a 2-layer LLM of hidden 64
    with the flagship's vocab) on the card: ``GenerationEngine`` with CUDA
    graphs, 6 greedy requests from threads into 4 slots (3 with a 256x256
    uint8 image, prompts of 100-460 tokens, one in 3 prefill segments of
    128), 24 new tokens each: every request's tokens equal batch-1
    ``caption_ids`` of its prompt exactly."""
    import dataclasses
    import threading

    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import InternLM2Config
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.serve.engine import GenerationEngine

    cfg = dataclasses.replace(
        small_config(), img_context_token_id=SPECIAL_IDS["<IMG_CONTEXT>"],
        llm=InternLM2Config(vocab_size=92553, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2))
    model = F.build_ullsam(cfg, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    qs = [("Hi?", True), ("Describe the image.", False),
          ("What is at the top left of the field?", True),
          ("Describe every structure you see in detail. " * 6, False),
          ("Count the cells.", False), ("Name one object.", True)]
    eng = GenerationEngine(model, cfg, StubTokenizer(), max_batch=4,
                           max_len=1024, cache_dtype=torch.float32,
                           gen=GenerationConfig(max_new_tokens=24),
                           prefill_chunk=128, device="cuda")
    prompts = {i: (eng.prompt_ids(q, im), img if im else None)
               for i, (q, im) in enumerate(qs)}
    reqs = {}

    def go(i):
        reqs[i] = eng.submit_ids(*prompts[i], 24)
        reqs[i].event.wait(SERVE_TIMEOUT)

    threads = [threading.Thread(target=go, args=(i,)) for i in prompts]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_TIMEOUT)
    finally:
        eng.shutdown()
    if any(t.is_alive() for t in threads) or len(reqs) != len(qs):
        fail("serve (a): a request did not finish")
    for i, r in reqs.items():
        if r.error is not None or not r.event.is_set():
            fail(f"serve (a): request {i} failed: {r.error!r}")
    lens = sorted(len(p[0]) for p in prompts.values())
    refs = _serve_refs(model, cfg, {
        i: (ids, None if pv is None else pv.astype(np.float32) / 255.0)
        for i, (ids, pv) in prompts.items()}, 24)
    same = [reqs[i].tokens == refs[i][0] for i in prompts]
    chunks, steps = _graph_replays(eng)
    say(f"[serve] (a) small f32 uLLSAM, GenerationEngine on the card, 6 "
        f"greedy requests into 4 slots (prompts {lens[0]}-{lens[-1]} "
        f"tokens, prefill segments of 128), 24 new tokens: tokens equal to "
        f"batch-1 caption_ids {sum(same)} of 6; {int(eng.phase_stats['graphs'])}"
        f" graphs captured {sorted(eng.graphs)}, {chunks} chunks "
        f"({steps} steps) replayed; {smi_line()}")
    if not all(same) or not chunks or max(lens) <= 256:
        fail(f"serve (a): engine tokens differ from caption_ids (equal: "
             f"{same}) or no graph ran ({chunks} replays)")
    del model, eng
    torch.cuda.empty_cache()


def _serve_round(eng, tag, kind, n, prompts, refs, exact, card):
    """n concurrent requests of ``kind`` ("image": the one image prompt;
    "text": the text prompts in turn), SERVE_NEW new tokens each; gates on
    completion, first tokens equal to ``refs``' (batch-1 ``caption_ids``)
    and prefill logits: relative L2 from ``exact`` (the f32 LLM of the
    same weights) at most SERVE_LOGIT_RATIO times ``refs``' own; prints
    the round's figures. Returns (tok/s, share of whole sequences
    equal)."""
    import time as _t
    ph0 = dict(eng.phase_stats)
    names = (["image"] * n if kind == "image"
             else [f"text{i}" for i in range(n)])
    t0 = _t.perf_counter()
    reqs = [eng.submit_ids(*prompts[m], SERVE_NEW) for m in names]
    for r in reqs:
        if not r.event.wait(SERVE_TIMEOUT) or r.error is not None:
            fail(f"serve {tag} {kind} x{n}: a request failed or timed out "
                 f"({r.error!r})")
    wall = max(r.t_done for r in reqs) - t0
    ntok = sum(len(r.tokens) for r in reqs)
    if any(not 1 <= len(r.tokens) <= SERVE_NEW for r in reqs):
        fail(f"serve {tag}: token counts {[len(r.tokens) for r in reqs]}")
    rel = [_rel_l2(r.first_logits, exact[m][1]) for r, m in zip(reqs, names)]
    tol = [SERVE_LOGIT_RATIO * _rel_l2(refs[m][1], exact[m][1])
           for m in names]
    to_ref = [_rel_l2(r.first_logits, refs[m][1])
              for r, m in zip(reqs, names)]
    first_ok = [r.tokens[0] == refs[m][0][0] for r, m in zip(reqs, names)]
    same = sum(r.tokens == refs[m][0] for r, m in zip(reqs, names)) / n
    ph = {k: eng.phase_stats[k] - ph0.get(k, 0.0) for k in eng.phase_stats}
    chunks = max(ph.get("chunks", 0.0), 1.0)
    loop_ms = sum(ph.get(k, 0.0) for k in ("admit", "dispatch", "commits",
                                           "sync")) * 1e3 / chunks
    dev_ms = ph.get("chunk_device", 0.0) * 1e3 / chunks
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    say(f"[serve] {tag} {kind} x{n}: {ntok} tokens in {wall * 1e3:.1f} ms "
        f"= {ntok / wall:.1f} tok/s (host clock, submit to last token); "
        f"time to first token {ttft[0]:.1f}-{ttft[-1]:.1f} ms; "
        f"{int(ph.get('chunks', 0))} chunks ({int(ph.get('steps', 0))} "
        f"steps): {dev_ms:.3f} ms a chunk on the device (CUDA events around "
        f"the replay), {loop_ms:.3f} ms of worker loop a chunk, busy share "
        f"{dev_ms / max(loop_ms, 1e-9):.3f}; captures in the round "
        f"{int(ph.get('graphs', 0))} ({ph.get('capture', 0.0):.2f} s); "
        f"first tokens equal {sum(first_ok)} of {n}, prefill logits "
        f"relative L2 from the f32 LLM {min(rel):.3e}-{max(rel):.3e} (tol "
        f"{SERVE_LOGIT_RATIO}x caption_ids' own: {min(tol):.3e}-"
        f"{max(tol):.3e}), from caption_ids {max(to_ref):.3e} (printed "
        f"only), whole sequences "
        f"equal to batch-1 caption_ids {same:.3f} (printed only); worker "
        f"phases (s) { {k: round(v, 4) for k, v in ph.items()} }; {card}")
    if not all(first_ok) or any(e > t for e, t in zip(rel, tol)):
        fail(f"serve {tag} {kind} x{n}: first tokens {first_ok}, prefill "
             f"logits relative L2 from the f32 LLM {rel} (tol {tol})")
    return ntok / wall, same


def serve_main_path() -> None:
    """(b) SAM ViT-B + InternLM2-1.8B at full width (random weights from the
    seed): ``GenerationEngine(max_batch=8, max_len=2560, prefill_chunk=256,
    steps_per_dispatch=8)`` with the engine's bf16 cache, greedy, on each
    of SERVE_ENGINES: a bf16 model, then with ``quant="int8"``, then the
    app's ``--dtype float32 --quant int8`` (an f32 model, every int8
    linear on B12 with f32 x: the decode body's f32 instance at the 8
    slots' rows, the wgmma GEMM's at the prompt segments, none on the FMA
    GEMM). Each takes a warm round (one image request, and one text request
    where its rounds have text), then its rounds of concurrent image
    caption requests (one 1024x1024 uint8 image, 1024 <IMG_CONTEXT> + the
    template's text) or text-only requests, SERVE_NEW new tokens each.
    Every request completes, its first token equals batch-1
    ``caption_ids``' (on the engine's LLM and cache dtype) and its prefill
    logits lie at most SERVE_LOGIT_RATIO times as far (relative L2) as
    ``caption_ids``' from an f32 LLM that holds the same weights (in int8
    the dequantized ones); in int8 a decode step launches B12 121 times
    (counted in each graph key's warm-up), in bf16 none. The f32 engine
    also prints an admission's device busy time. (c) the port's app at full
    width in bf16 with ``--engine`` and the stub tokenizer on a free port,
    driven through ``_smoke``."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.serve import app as A
    from ullsam_tpu_torch.serve.engine import GenerationEngine

    card = smi_line()
    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (1, 1024, 1024, 3), dtype=np.uint8)
    tk = StubTokenizer()
    model, model_dtype = None, None
    for tag, dname, quant, rounds, admission in SERVE_ENGINES:
        dtype = getattr(torch, dname)
        if dtype != model_dtype:
            del model
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            model = F.build_ullsam(cfg, device="cuda", dtype=dtype,
                                   seed=SEED)
            model_dtype = dtype
            torch.cuda.synchronize()
            weights = torch.cuda.memory_allocated()
            say(f"[serve] {dname} model built in "
                f"{time.perf_counter() - t0:.1f} s; {card}")
        eng = GenerationEngine(model, cfg, tk, max_batch=8, max_len=2560,
                               prefill_chunk=256, steps_per_dispatch=8,
                               quant=quant, device="cuda")
        prompts = {"image": (eng.prompt_ids(SERVE_IMAGE_Q, True), img)}
        if any(kind == "text" for kind, _ in rounds):
            prompts.update({f"text{i}": (eng.prompt_ids(q, False), None)
                            for i, q in enumerate(SERVE_TEXT_QS)})
        scaled = {k: (ids, None if pv is None else pv.astype(np.float32) / 255)
                  for k, (ids, pv) in prompts.items()}
        refs, exact = _engine_refs(model, cfg, eng, scaled, quant)
        own = [_rel_l2(refs[k][1], exact[k][1]) for k in prompts]
        say(f"[serve] {tag}: batch-1 caption_ids ({eng.cache_dtype} cache) "
            f"prefill logits against the f32 LLM of the same weights: "
            f"relative L2 {min(own):.3e}-{max(own):.3e} (the engine's may "
            f"be {SERVE_LOGIT_RATIO}x that); {card}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        b12 = Q.w8a16_matmul.launches
        k12 = b12_counts()
        warm = [eng.submit_ids(*prompts[k], SERVE_NEW)
                for k in ("image", "text0") if k in prompts]
        if any(not r.event.wait(SERVE_TIMEOUT) or r.error for r in warm):
            fail(f"serve {tag}: the warm round failed")
        say(f"[serve] {tag}: warm round ({len(warm)} requests), "
            f"{int(eng.phase_stats['graphs'])} graphs captured in "
            f"{eng.phase_stats['capture']:.2f} s; prompt lengths "
            f"{sorted({len(p[0]) for p in prompts.values()})}; {card}")
        rates = {r: _serve_round(eng, tag, *r, prompts, refs, exact, card)
                 for r in rounds}
        eng.shutdown()
        if eng.error is not None:
            fail(f"serve {tag}: the engine failed: {eng.error!r}")
        peak = torch.cuda.max_memory_allocated() - weights
        chunks, steps = _graph_replays(eng)
        per_step = sorted(set(eng.step_launches.values()))
        # int8: the decode steps' warm-ups at the 8 slots' rows, the prompt
        # segments on the wgmma GEMM, each prompt's head on its last row
        ran12 = {k: v - k12[k] for k, v in b12_counts().items()
                 if v != k12[k]}
        want12 = (set(b12_pass(8, dtype=dtype))
                  | set(b12_pass(256, B12_LINEARS[:4], dtype=dtype))
                  | set(b12_pass(1, B12_LINEARS[4:], dtype=dtype))
                  ) if quant else set()
        SERVE[tag] = {"graph_chunks": chunks, "graph_steps": steps,
                      "b12_per_decode_step": per_step,
                      "b12_kernels": sorted(ran12)}
        adm = ""
        if admission:
            adm_wall, adm_busy = _admission_ms(eng, prompts["image"])
            adm = (f"an image admission {adm_busy:.3f} ms busy on the device "
                   f"of {adm_wall:.3f} ms (host clock; torch.profiler, one "
                   f"admission after a warm one); ")
        say(f"[serve] {tag}: tok/s "
            + ", ".join(f"{kind} x{n} {rates[(kind, n)][0]:.1f}"
                        for kind, n in rounds)
            + f"; {adm}{int(eng.phase_stats['graphs'])} graphs "
            f"{sorted(eng.graphs)} captured in "
            f"{eng.phase_stats['capture']:.2f} s; {chunks} chunks ({steps} "
            f"decode steps) replayed; B12 launches a decode step by the "
            f"warm-ups {per_step}; B12 kernels launched (eager: the prompt "
            f"segments and the warm-ups) {ran12}; "
            f"{Q.w8a16_matmul.launches - b12} B12 wrapper calls; peak "
            f"{peak / 2**30:.3f} GiB above the {weights / 2**30:.3f} GiB of "
            f"weights (cache, int8 copy, row caches, graphs); phase_stats "
            f"{dict(eng.phase_stats)}; {card}")
        want = [float(B12_PER_PASS)] if quant else [0.0]
        if per_step != want or (not quant
                                and Q.w8a16_matmul.launches != b12):
            fail(f"serve {tag}: B12 launches a decode step {per_step}, "
                 f"expected {want}")
        if set(ran12) != want12:
            fail(f"serve {tag}: B12 kernels {sorted(ran12)}, expected "
                 f"{sorted(want12)}")
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    # (c) the app: its own full-width bf16 model and engine
    t0 = time.perf_counter()
    app = A.build_app(A.parse_args(["--engine", "--device", "cuda",
                                    "--dtype", "bfloat16"]),
                      tokenizer=StubTokenizer())
    try:
        ok = A.serve_smoke(app)
    except AssertionError as e:
        fail(f"serve (c): the app smoke failed: {e}")
    finally:
        app.engine.shutdown()
    if not ok or app.engine.error is not None:
        fail(f"serve (c): the app smoke failed ({app.engine.error!r})")
    say(f"[serve] (c) app at full width, bf16, --engine, stub tokenizer: "
        f"image, 2 clicks, mask, save, view, TIFF export, caption, caption "
        f"stream ok in {time.perf_counter() - t0:.1f} s (model build "
        f"included); {card}")
    del app
    torch.cuda.empty_cache()



def _admission_ms(eng, prompt) -> tuple:
    """(wall, device busy) ms of one admission of ``prompt`` (ids, image:
    the ViT encode, the prompt's segments of 256, the first token, the
    splice) on this thread after a warm one, uncounted (torch.profiler)."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.serve.engine import Request
    ids = np.asarray(prompt[0], np.int64)

    def admit():
        pend = eng._admit_start(0, Request(ids, prompt[1], SERVE_NEW))
        while eng._admit_advance(pend) is None:
            pass

    saved = launch_counts()
    with Q.uncounted(), torch.inference_mode():
        admit()
        out = _busy_ms(admit)
    _restore_counts(saved)
    return out


# ---------------------------------------------------------------------------
# phase 10: SAM ViT-H automatic mask generation
# ---------------------------------------------------------------------------

# the opt-in kernels: each runs on the ViT-H path behind its switch
VIT_H_KERNELS = (
    ("ln_mlp", "ullsam_tpu_torch/csrc/ln_mlp.cu",
     "ullsam_tpu/ops/pallas/vit_block.py:60"),
    ("vit_flash_attn_packed", "ullsam_tpu_torch/csrc/vit_flash_attn.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:198"),
    ("window_attn_core_twophase",
     "ullsam_tpu_torch/csrc/window_attn_twophase.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:1064"))

def _errs(name: str, dname: str, got, ref, tol: float) -> float:
    """max|kernel - plain| over every output; fails beyond ``tol`` of
    max|plain| or on a non-finite value."""
    import torch
    outs = got if isinstance(got, tuple) else (got,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(outs, refs)]
    rel = max(e / max(float(b.float().abs().max()), 1e-30)
              for e, b in zip(errs, refs))
    ok = rel <= tol and all(bool(torch.isfinite(a).all()) for a in outs)
    say(f"[vit_h] {name} {dname}: max_abs_err={max(errs):.3e} "
        f"max_rel_err={rel:.3e} over {len(outs)} output(s) (relative to "
        f"max|plain|; tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {dname} disagrees with its plain version")
    return max(errs)


def check_vit_h_kernels(card: str, rows: dict) -> dict:
    """Phase 10 (a): B1, B2, B3, B8 and B9 at head dim 80 (entries ``vit_h``
    and ``vit_h_float32`` of their rows; B8 and B9 at ViT-H training's
    shapes), B13, B14, B15 (their own rows at ViT-H, entries ``vit_b`` /
    ``vit_b_float32`` at ViT-B) and B14's backward at head dim 80 (entries
    ``vit_h_backward`` of its row: the heads split, B9, dqkv packed) against
    their plain versions at the path's shapes, bf16 and f32, each timed with
    its plain version, the library yardstick and the bound."""
    import functools

    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    from ullsam_tpu_torch.ops.kernels.window_attention import (_rel_terms,
                                                               _split_heads)
    from ullsam_tpu_torch.tools.main_path import (
        FLASH_BWD_VIT_H, VIT_B, VIT_H, ln_mlp_case, vit_flash_bwd_case,
        vit_flash_case, vit_flash_packed_case, window_attn_case,
        window_core_case)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    opt_in = {name for name, _, _ in VIT_H_KERNELS}
    for name, source, replaces in VIT_H_KERNELS:
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces}

    def window_lib(qkv, rh, rw, backward=False):
        """SDPA with the window bias materialized: B3's and B15's yardstick,
        and with ``backward`` B8's (its backward alone)."""
        ws, hd = rh.shape[0], rh.shape[-1]
        q, k, v = (t.to(qkv.dtype) for t in _split_heads(qkv, ws * ws, hd))
        rel_h, rel_w = _rel_terms(q.float(), rh.float(), rw.float(), ws, ws)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2).to(
            qkv.dtype)
        return _sdpa_ms(q, k, v, bias, backward)

    # B3 and B15 compute one function: at one shape they share one reading
    # (ViT-B's is B3's row from phase 3's train kernels)
    shared_lib = {}

    def window_fwd_lib(tag, args):
        if tag not in shared_lib:
            shared_lib[tag] = window_lib(*args)
        return shared_lib[tag]

    def flash_lib(args):
        q, k, v, rh, rw = args
        BH, N, _ = q.shape
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(1, BH, N, N)
        return _sdpa_ms(q[None], k[None], v[None], bias, False)

    def packed_lib(args, nh):
        qkv, rh, rw = args
        B, N, C3 = qkv.shape
        C = C3 // 3
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, N, nh, C // nh)
                   .transpose(1, 2) for i in range(3))
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(B, nh, N, N)
        return _sdpa_ms(q, k, v, bias, False)

    # B9 and B14's backward compute one function: one SDPA backward reading
    # a dtype
    bwd_lib = {}

    def flash_bwd_lib(args):
        if "ms" not in bwd_lib:
            q, k, v, rh, rw = args[:5]
            BH, N, _ = q.shape
            bias = (rh.float()[..., :, None] + rw.float()[..., None, :]
                    ).reshape(1, BH, N, N).to(q.dtype)
            bwd_lib["ms"] = _sdpa_ms(q[None], k[None], v[None], bias, True)
        return bwd_lib["ms"]

    def ln_mlp_lib(args, kw):
        """The default route's chain of library calls (no single call
        computes B13): layer_norm, linear, tanh-GELU, linear, residual."""
        x, lw, lb, w1, b1, w2, b2 = args
        C = x.shape[-1]
        return cuda_time_ms(lambda: x + F.linear(F.gelu(F.linear(
            F.layer_norm(x, (C,), lw, lb, kw["eps"]), w1, b1),
            approximate="tanh"), w2, b2), iters=10)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        fwd, bwd, cflops, cbytes = window_core_case(dtype, gen, nh=16, hd=80)
        b3 = rows["window_attn_core"]
        shared_lib.clear()
        shared_lib["vit_b"] = (b3 if dtype == torch.bfloat16
                               else b3["float32"])["library_ms"]
        cases = []
        for tag, width in (("vit_h", VIT_H), ("vit_b", VIT_B)):
            if tag == "vit_h":
                a, kw, fl, nb = window_attn_case(dtype, gen, **width)
                cases.append(("window_attn", tag, VB.window_attn,
                              VB.window_attn_plain, a, kw, fl, nb, None))
                a, kw, fl, nb = vit_flash_case(dtype, gen, **width)
                cases.append(("vit_flash_attn", tag, FA.vit_flash_attn,
                              FA.vit_flash_attn_plain, a, kw, fl, nb,
                              lambda a=a: flash_lib(a)))
                cases.append(("window_attn_core", tag, WA.window_attn_core,
                              WA.window_attn_core_plain, fwd, {},
                              cflops["fwd"], cbytes["fwd"],
                              lambda: window_fwd_lib("vit_h", fwd)))
                cases.append(("window_attn_core_bwd", tag,
                              WA.window_attn_core_bwd,
                              WA.window_attn_core_bwd_plain, bwd, {},
                              cflops["bwd"], cbytes["bwd"],
                              lambda: window_lib(*fwd, backward=True)))
                b9, fl, nb = vit_flash_bwd_case(dtype, gen,
                                                **FLASH_BWD_VIT_H)
                bwd_lib.clear()
                cases.append(("vit_flash_attn_bwd", tag, FA.vit_flash_attn_bwd,
                              FA.vit_flash_attn_bwd_plain, b9, {}, fl, nb,
                              lambda a=b9: flash_bwd_lib(a)))
                # B14's backward on B14's own forward: the same B9 call
                # between a head split and a repack
                qkv, prh, prw = vit_flash_packed_case(dtype, gen,
                                                      **width)[0]
                o, lse = FA.vit_flash_attn_packed(qkv, prh, prw, width["nh"])
                g = torch.randn(o.shape, generator=gen,
                                device="cuda").to(dtype)
                eb = qkv.element_size()
                pb = ((2 * qkv.numel() + 2 * o.numel() + prh.numel()
                       + prw.numel()) * eb + lse.numel() * 4
                      + (prh.numel() + prw.numel()) * 4)
                cases.append(("vit_flash_attn_packed", "vit_h_backward",
                              FA.vit_flash_packed_bwd,
                              functools.partial(
                                  FA.vit_flash_packed_bwd,
                                  bwd=FA.vit_flash_attn_bwd_plain),
                              (qkv, prh, prw, o, lse, g), {"nh": width["nh"]},
                              fl, pb, lambda a=b9: flash_bwd_lib(a)))
                twophase = fwd
                tflops, tbytes = cflops["fwd"], cbytes["fwd"]
            else:
                twophase, _, f2, b2 = window_core_case(dtype, gen, nh=12,
                                                       hd=64)
                tflops, tbytes = f2["fwd"], b2["fwd"]
            for T in (4900, 4096):  # a windowed and a global block
                a, kw, fl, nb = ln_mlp_case(dtype, gen, T=T, **width)
                cases.append(("ln_mlp", f"{tag}_T{T}", VB.ln_mlp,
                              VB.ln_mlp_plain, a, kw, fl, nb,
                              lambda a=a, kw=kw: ln_mlp_lib(a, kw)))
            a, kw, fl, nb = vit_flash_packed_case(dtype, gen, **width)
            cases.append(("vit_flash_attn_packed", tag,
                          FA.vit_flash_attn_packed,
                          FA.vit_flash_attn_packed_plain, a, kw, fl, nb,
                          lambda a=a, nh=width["nh"]: packed_lib(a, nh)))
            cases.append(("window_attn_core_twophase", tag,
                          WA.window_attn_core_twophase,
                          WA.window_attn_core_twophase_plain, twophase, {},
                          tflops, tbytes,
                          lambda tag=tag, t=twophase:
                          window_fwd_lib(tag, t)))
        for name, tag, kernel, plain, args, kw, flops, nbytes, lib in cases:
            got, ref = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = _errs(f"{name} ({tag})", dname, got, ref, tol[dtype])
            f64 = (f64_hold(f"{name} ({tag})", plain, args, got, ref,
                            "vit_h", kw)
                   if dtype == torch.float32 and name in SPLIT_TF32
                   and (tag == "vit_h" or name in FWD_TF32) else {})
            if (name in ("vit_flash_attn", "vit_flash_attn_packed")
                    and tag != "vit_h_backward"):
                lse_rel = float((got[1] - ref[1]).abs().max()
                                / ref[1].abs().max())
                say(f"[vit_h] {name} ({tag}) {dname}: lse max_rel_err="
                    f"{lse_rel:.3e} (tol {LSE_TOL:.0e}) "
                    f"{'ok' if lse_rel <= LSE_TOL else 'FAIL'}")
                if lse_rel > LSE_TOL:
                    fail(f"{name} ({tag}) {dname}: lse disagrees with plain")
            del got, ref
            ms = cuda_time_ms(lambda: kernel(*args, **kw), iters=10)
            plain_ms = cuda_time_ms(lambda: plain(*args, **kw), iters=2,
                                    warmup=1)
            lib_ms = None if lib is None else lib()
            torch.cuda.empty_cache()
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            say(f"[vit_h] {name} ({tag}) {dname}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; data-sheet peaks at 700 W, card: "
                f"{card}), {flops / ms / 1e9:.1f} TFLOP/s")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     **f64}
            # an opt-in kernel's own numbers are ViT-H's (B13's: a windowed
            # block's); every other case is an entry of its row
            main = (name in opt_in and tag == ("vit_h_T4900" if name ==
                                               "ln_mlp" else "vit_h"))
            if main and dtype == torch.bfloat16:
                rows[name].update(entry)
            elif main:
                rows[name]["float32"] = entry
            else:
                rows[name][tag if dtype == torch.bfloat16
                          else f"{tag}_float32"] = entry
        del cases, fwd, bwd, twophase, b9, qkv, prh, prw, o, lse, g
        torch.cuda.empty_cache()
    return rows


# (tag, N, K, act, residual) of each bf16 product of B1 and B13 (qkv, proj;
# fc1 with the GELU, fc2 with the residual) at SAM ViT-B and ViT-H
GEMM_PRODUCTS = (
    ("vit_h_qkv", 3840, 1280, "none", False),
    ("vit_h_proj", 1280, 1280, "none", True),
    ("vit_h_fc1", 5120, 1280, "gelu_tanh", False),
    ("vit_h_fc2", 1280, 5120, "none", True),
    ("vit_b_qkv", 2304, 768, "none", False),
    ("vit_b_proj", 768, 768, "none", True))


def check_gemm_kernel(card: str) -> dict:
    """Phase 10 (a'): the wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) that
    carries B1's and B13's bf16 products, at each product's shape with M =
    4900 (a windowed block; B13's also at 4096, a global block) against
    its f32 plain product (tolerance 2e-2 of max|plain|, as every bf16
    kernel), one launch of the kernel each by its own count, timed beside
    ``F.linear`` on the same operands (bias included) and the bound. The
    row's own numbers are ViT-H's qkv, the product the default route runs
    28 times an image."""
    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import gemm as G

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    row = {"name": "gemm_sm90", "route": "cuda",
           "source": "ullsam_tpu_torch/csrc/gemm_sm90.cuh",
           "replaces": "ullsam_tpu/ops/pallas/vit_block.py:60",
           "carries": "the bf16 products of B1 (vit_block.py:203) and B13"}

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * s).to(torch.bfloat16)

    cases = [(tag, 4900, *rest) for tag, *rest in GEMM_PRODUCTS]
    cases += [(tag, 4096, *rest) for tag, *rest in GEMM_PRODUCTS
              if tag in ("vit_h_fc1", "vit_h_fc2")]
    for tag, M, N, K, act, with_res in cases:
        a, w, b = r(M, K), r(N, K, s=K ** -0.5), r(N, s=0.1)
        res = r(M, N) if with_res else None
        if G.gemm_kernel(M, N, K) != "gemm_sm90":
            fail(f"gemm {tag}: M={M} N={N} K={K} is not the wgmma kernel's")
        before = (G.gemm_sm90.launches, G.gemm_mma.launches)
        got = G.gemm_bf16(a, w, b, res, act)
        torch.cuda.synchronize()
        counts = (G.gemm_sm90.launches - before[0],
                  G.gemm_mma.launches - before[1])
        ref = G.gemm_plain(a, w, b, res, act)
        err = float((got.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        ok = (rel <= 2e-2 and bool(torch.isfinite(got).all())
              and counts == (1, 0))
        say(f"[gemm] {tag} M={M} N={N} K={K} {act}"
            f"{' +residual' if with_res else ''}: max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (relative to max|plain|, f32 product; "
            f"tol 2e-02), launches wgmma +{counts[0]} mma.sync +{counts[1]}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"gemm {tag} disagrees with its plain version or did not "
                 f"take the wgmma kernel")
        del got, ref
        ms = cuda_time_ms(lambda: G.gemm_bf16(a, w, b, res, act), iters=20,
                          warmup=3)
        plain_ms = cuda_time_ms(lambda: G.gemm_plain(a, w, b, res, act),
                                iters=2, warmup=1)
        lib_ms = cuda_time_ms(lambda: F.linear(a, w, b), iters=20, warmup=3)
        flops = 2 * M * N * K
        nbytes = 2 * (M * K + N * K + N + M * N * (2 if with_res else 1))
        b_ms, b_by = bound_ms(flops, nbytes, torch.bfloat16)
        say(f"[gemm] {tag} M={M}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"library F.linear {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} "
            f"TFLOP/s), bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 1e6:.1f} MB; data-sheet peaks at 700 W, "
            f"card: {card})")
        entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if tag == "vit_h_qkv" and M == 4900:
            row.update(entry)
        else:
            row[f"{tag}_M{M}"] = entry
        del a, w, b, res
        torch.cuda.empty_cache()
    return {"gemm_sm90": row, "gemm_sm90_f32": check_gemm_f32(card, cases)}


def check_gemm_f32(card: str, cases) -> dict:
    """Phase 10 (a''): the wgmma GEMM's f32 kind (split TF32), which
    carries B1's and B13's f32 products, at ``check_gemm_kernel``'s cases
    in float32: against the f32 plain product (tolerance 1e-4 of
    max|plain|) and a float64 evaluation of it (within F64_RATIO x the
    plain f32 version's own error), one launch of the kind and none of the
    FMA GEMM each, timed beside ``F.linear`` in float32 (TF32 off) and the
    bound. The row's own numbers are ViT-H's qkv."""
    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import gemm as G

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    row = {"name": "gemm_sm90_f32", "route": "cuda",
           "source": "ullsam_tpu_torch/csrc/gemm_sm90.cuh",
           "replaces": "ullsam_tpu/ops/pallas/vit_block.py:60",
           "carries": "the f32 products of B1 (vit_block.py:203) and B13, "
                      "split TF32"}

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * s

    for tag, M, N, K, act, with_res in cases:
        a, w, b = r(M, K), r(N, K, s=K ** -0.5), r(N, s=0.1)
        res = r(M, N) if with_res else None
        if G.gemm_kernel(M, N, K, torch.float32) != "gemm_sm90_f32":
            fail(f"gemm f32 {tag}: M={M} N={N} K={K} is not the f32 kind's")
        c0 = c_counts()
        got = G.gemm_f32(a, w, b, res, act)
        torch.cuda.synchronize()
        dc = {k: v - c0[k] for k, v in c_counts().items()}
        ref = G.gemm_plain(a, w, b, res, act)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ok = (rel <= 1e-4 and bool(torch.isfinite(got).all())
              and (dc["gemm_sm90_f32"], dc["gemm_fma"]) == (1, 0))
        say(f"[gemm] f32 {tag} M={M} N={N} K={K} {act}"
            f"{' +residual' if with_res else ''}: max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (relative to max|plain|; tol 1e-04), "
            f"launches f32 kind +{dc['gemm_sm90_f32']} FMA "
            f"+{dc['gemm_fma']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"gemm f32 {tag} disagrees with its plain version or did "
                 f"not take the f32 kind")
        f64 = f64_hold(f"gemm f32 {tag} M={M}", G.gemm_plain,
                       (a, w, b, res, act), got, ref, "gemm")
        del got, ref
        ms = cuda_time_ms(lambda: G.gemm_f32(a, w, b, res, act), iters=10,
                          warmup=2)
        plain_ms = cuda_time_ms(lambda: G.gemm_plain(a, w, b, res, act),
                                iters=2, warmup=1)
        lib_ms = cuda_time_ms(lambda: F.linear(a, w, b), iters=10, warmup=2)
        flops = 2 * M * N * K
        nbytes = 4 * (M * K + N * K + N + M * N * (2 if with_res else 1))
        b_ms, b_by = bound_ms(flops, nbytes, torch.float32)
        say(f"[gemm] f32 {tag} M={M}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"library F.linear {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} "
            f"TFLOP/s), bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 1e6:.1f} MB; split TF32 at 495 / 3 TFLOP/s, "
            f"700 W; card: {card})")
        entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                 **f64}
        if tag == "vit_h_qkv" and M == 4900:
            row.update(entry)
        else:
            row[f"{tag}_M{M}"] = entry
        del a, w, b, res
        torch.cuda.empty_cache()
    return row


def vit_h_small_config():
    """An encoder that every ViT-H route's gate takes: 8 heads of 80 (C =
    640, C % 128 == 0), a 32x32 grid (N = 1024) in 14x14 windows (padded
    to 42x42: 9 windows, pad tokens masked), a windowed then a global
    block."""
    from ullsam_tpu_torch.core.config import ViTConfig
    return ViTConfig(img_size=512, patch_size=16, embed_dim=640, depth=2,
                     num_heads=8, out_chans=64, window_size=14,
                     global_attn_indexes=(1,))


def vit_h_small_reference_check() -> None:
    """Phase 10 (b): the small hd-80 encoder from one set of weights, plain
    versions on the CPU against the kernels on the card, float32, under
    each route setting: within 1e-4 of max|out| (summation order), with
    exactly the route's launches."""
    import torch
    from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.tools.main_path import (VIT_H_ROUTES,
                                                  route_launches, switches)

    cfg = vit_h_small_config()
    cpu = ImageEncoder(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(SEED)
    L.init_module_(cpu, gen)
    gpu = ImageEncoder(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 512, 512, 3, generator=gen)
    for route, env in VIT_H_ROUTES.items():
        with switches(env), torch.no_grad():
            ref = cpu(x)
            before = launch_counts()
            got = gpu(x.cuda())
            torch.cuda.synchronize()
            d = {k: v - before[k] for k, v in launch_counts().items()
                 if v != before[k]}
        rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
        say(f"[reference] small hd-80 encoder, route {route}, CPU plain vs "
            f"GPU kernels: max_rel_err={rel:.3e} (tol 1e-4), launches {d}")
        if d != route_launches(env, 1, 1):
            fail(f"small hd-80 encoder, route {route}: launches {d}, "
                 f"expected {route_launches(env, 1, 1)}")
        if not rel <= 1e-4:
            fail(f"small hd-80 encoder, route {route}: GPU vs CPU {rel:.3e}")


def vit_h_main_path() -> None:
    """Phase 10 (c): SAM ViT-H at full width (``build_sam("vit_h")``, random
    weights from the seed), 1024x1024 uint8 images, 32x32 points in chunks
    of 256, thresholds and NMS off, at most 256 masks."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
    from ullsam_tpu_torch.models.sam import sam as S
    from ullsam_tpu_torch.models.sam.registry import build_sam
    from ullsam_tpu_torch.tools.main_path import (VIT_H_ROUTES, amg_inputs,
                                                  route_launches, switches)

    t0 = time.perf_counter()
    cfg, model32 = build_sam("vit_h", seed=SEED, device="cuda")
    model16 = S.Sam(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    model16.eval()
    n_params = sum(p.numel() for p in model32.parameters())
    model32.to("cpu")  # one model on the card at a time, for its memory
    torch.cuda.empty_cache()
    say(f"[vit_h] SAM ViT-H, {n_params / 1e6:.1f} M params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    images = amg_inputs(np.random.default_rng(SEED), 4)
    sweep = dict(points_per_side=32, points_per_batch=256, max_masks=256,
                 pred_iou_thresh=0.0, stability_score_thresh=0.0,
                 box_nms_thresh=1.0)
    decoder = {"decode_masks": 4, "two_way_transformer": 4,
               "upscale_hypernet_stats": 4, "upscale_hypernet": 4}

    def gemm_check(tag, d, g0, bf16, decoder_too):
        """Every bf16 product of B1 and B13 took the wgmma GEMM: two a
        launch of either; f32 takes neither bf16 GEMM but its f32 kind,
        and the f32 window core (``check_f32_kinds``). The decoder's
        products (B4-B7) run gemm.cuh's mma.sync kernel."""
        dg = check_f32_kinds(f"ViT-H {tag}", d, g0, not bf16)
        sm90 = 2 * (d.get("window_attn", 0) + d.get("ln_mlp", 0))
        if dg["gemm_sm90"] != (sm90 if bf16 else 0) or (
                not decoder_too and dg["gemm_mma"] != 0):
            fail(f"ViT-H {tag}: GEMM launches {dg}, expected gemm_sm90 "
                 f"{sm90 if bf16 else 0}")
        return dg

    def run(generator, image, tag, want):
        before = launch_counts()
        g0 = c_counts()
        f0 = fused_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, data = generator.generate_dense(image)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
        dg = gemm_check(tag, d, g0, "f32" not in tag, True)
        check_fused(f"ViT-H AMG {tag}", f0, d.get("decode_masks", 0),
                    "f32" not in tag)
        n = len(data["iou_preds"])
        if (masks.dtype != torch.bool or tuple(masks.shape) != (n, 1024, 1024)
                or n != 256 or not np.isfinite(data["iou_preds"]).all()
                or not np.isfinite(data["stability"]).all()):
            fail(f"ViT-H AMG {tag}: masks {tuple(masks.shape)} {masks.dtype}")
        say(f"[vit_h] {tag}: {n} masks, latency {ms:.1f} ms (host clock, "
            f"ends in synchronize), launches {d}, GEMMs {dg}")
        if d != want:
            fail(f"ViT-H AMG {tag}: launches {d}, expected {want}")
        return ms, masks, data

    default = dict(route_launches({}, 28, 4), **decoder)
    g16 = AutomaticMaskGenerator(cfg, model16, **sweep)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run(g16, images[0], "bf16 warm image", default)
    timed = [run(g16, img, f"bf16 image {i}", default)
             for i, img in enumerate(images[1:4], 1)]
    peak = torch.cuda.max_memory_allocated()
    total_s = sum(t[0] for t in timed) / 1e3
    say(f"[vit_h] bf16 deterministic sweep (thresholds and NMS off), 3 timed "
        f"images: {3 * 256 / total_s:.1f} masks/s, {3 / total_s:.3f} "
        f"images/s, latency {', '.join(f'{t[0]:.1f}' for t in timed)} ms")
    say(f"[vit_h] bf16: weights {weights / 2**30:.3f} GiB resident, peak "
        f"{peak / 2**30:.3f} GiB (max_memory_allocated), so "
        f"{(peak - weights) / 2**30:.3f} GiB for the sweep; its parts: "
        f"{sweep_peak_parts(model16, cfg, images[1])}")

    # the encode alone under each route setting, on image 1
    x = S.preprocess(torch.from_numpy(images[1]).cuda().float()[None],
                     cfg).to(torch.bfloat16)
    embs = {}
    for route, env in VIT_H_ROUTES.items():
        want = route_launches(env, 28, 4)
        with switches(env), torch.no_grad():
            S.encode_image(model16.image_encoder, x)
            lat = []
            for _ in range(5):
                before = launch_counts()
                g0 = c_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                emb = S.encode_image(model16.image_encoder, x)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                d = {k: v - before[k] for k, v in launch_counts().items()
                     if v != before[k]}
                dg = gemm_check(f"encode, route {route}", d, g0, True, False)
                if d != want:
                    fail(f"ViT-H encode, route {route}: launches {d}, "
                         f"expected {want}")
        if tuple(emb.shape) != (1, 64, 64, 256) or not bool(
                torch.isfinite(emb).all()):
            fail(f"ViT-H encode, route {route}: {tuple(emb.shape)}")
        embs[route] = emb.float()
        say(f"[vit_h] bf16 encode, route {route}: "
            f"{', '.join(f'{t:.2f}' for t in lat)} ms (host clock, ends in "
            f"synchronize; median {sorted(lat)[2]:.2f}), launches {d}, "
            f"GEMMs {dg}")

    every = dict(VIT_H_ROUTES["unfused_twophase"], ULLSAM_FUSED_VIT_MLP="1",
                 ULLSAM_PACKED_GLOBAL="1")
    with switches(every):
        want = dict(route_launches(every, 28, 4), **decoder)
        _, m_all, d_all = run(g16, images[1],
                              "bf16 image 1, every switch on (B13, B14, "
                              "B15)", want)
    _, m_def, d_def = timed[0]
    agree = float((m_all == m_def).float().mean())
    d_iou = float(np.abs(d_all["iou_preds"] - d_def["iou_preds"]).max())
    say(f"[vit_h] every switch vs default, image 1: mask pixel agreement "
        f"{agree:.4f}, iou max diff {d_iou:.3e} (printed only)")
    del m_all, m_def, timed

    model16.to("cpu")
    torch.cuda.empty_cache()
    model32.to("cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g32 = AutomaticMaskGenerator(cfg, model32, **sweep)
    run(g32, images[0], "f32 warm image (TF32 off)", default)
    timed32 = [run(g32, img, f"f32 image {i} (TF32 off)", default)
               for i, img in enumerate(images[1:4], 1)]
    peak = torch.cuda.max_memory_allocated()
    say(f"[vit_h] f32 deterministic sweep, 3 timed images: "
        f"{768 / (sum(t[0] for t in timed32) / 1e3):.1f} masks/s, latency "
        f"{', '.join(f'{t[0]:.1f}' for t in timed32)} ms")
    say(f"[vit_h] f32: weights {weights / 2**30:.3f} GiB resident, peak "
        f"{peak / 2**30:.3f} GiB, so {(peak - weights) / 2**30:.3f} GiB for "
        f"the sweep; its parts: {sweep_peak_parts(model32, cfg, images[1])}")
    del timed32
    with switches({}), torch.no_grad():
        e32 = S.encode_image(model32.image_encoder, x.float()).float()
    scale = float((embs["default"] - e32).norm() / e32.norm())
    # a route rounds bf16 values at other points than the default route,
    # so its distance from it is bf16 noise: held to 3x the default
    # route's own distance from float32
    tol = 3 * scale
    say(f"[vit_h] bf16 default-route embedding vs f32: relative L2 "
        f"{scale:.3e}; each route vs the default held to {tol:.3e}")
    for route in VIT_H_ROUTES:
        rel = float((embs[route] - embs["default"]).norm()
                    / embs["default"].norm())
        say(f"[vit_h] bf16 embedding, route {route} vs default: relative L2 "
            f"{rel:.3e} {'ok' if rel <= tol else 'FAIL'}")
        if not rel <= tol:
            fail(f"ViT-H route {route}: embedding {rel:.3e} from the "
                 f"default's (tol {tol:.3e})")
    del model32, model16, embs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the segmentation train step at SAM ViT-H
# ---------------------------------------------------------------------------

# a step of (a) bf16 and (c) f32 without remat: B1 in the 28 windowed
# blocks (B3 + B8 in their backward), B2 and B9 in the 4 global ones
TRAIN_VIT_H_PER_STEP = {"window_attn": 28, "window_attn_core": 28,
                        "window_attn_core_bwd": 28, "vit_flash_attn": 4,
                        "vit_flash_attn_bwd": 4}
# (d) every switch on: LN1 + qkv + B15 + proj in the windows (B8 in their
# backward), B13 in every MLP half (its backward plain), B14 in the global
# blocks (B9 in its backward)
TRAIN_VIT_H_EVERY = {"window_attn_core_twophase": 28,
                     "window_attn_core_bwd": 28, "ln_mlp": 32,
                     "vit_flash_attn_packed": 4, "vit_flash_attn_bwd": 4}


def train_vit_h_main_path() -> None:
    """The JAX CLI's ``--mode segment --sam_variant vit_h`` at full width:
    SAM ViT-H (16 heads of 80) + InternLM2-1.8B frozen, random weights from
    the seed, the flagship batch. (a) bf16 without remat, 1 warm and 3
    timed steps; then from the same starting weights (b) an f32 step with
    remat (the JAX CLI's defaults), (c) an f32 step without remat (f32 B8
    at head dim 80 in 28 blocks), held to (b) in loss, grad norm and every
    gradient; (d) one bf16 step under every switch (B13, B14 with its
    backward through B9, B15 + B8), held to (a)'s step 1."""
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_h)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import VIT_H_ROUTES, switches
    from ullsam_tpu_torch.train import step as S

    pre = "train_vit_h"
    cfg = FusionConfig(sam=sam_vit_h(), llm=internlm2_1_8b())
    model32, batch, first, second = train_bf16_steps(
        cfg, "SAM ViT-H + InternLM2-1.8B", TRAIN_VIT_H_PER_STEP, pre)
    torch.cuda.empty_cache()
    refs = [first, second]
    every = dict(VIT_H_ROUTES["unfused_twophase"], ULLSAM_FUSED_VIT_MLP="1",
                 ULLSAM_PACKED_GLOBAL="1")
    model16 = F.ULLSAM(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    with switches(every):
        all_on = train_steps(cfg, batch, model16,
                             S.TrainConfig(total_steps=100, remat=False),
                             "bf16, every switch on", 1, refs, pre,
                             want=TRAIN_VIT_H_EVERY)
    del model16
    torch.cuda.empty_cache()
    model32.to("cuda")
    f32_remat = train_steps(cfg, batch, model32,
                            S.TrainConfig(total_steps=100, remat=True),
                            "f32 (TF32 off) with remat", 1, refs, pre,
                            want=TRAIN_REMAT)
    f32 = train_steps(cfg, batch, model32,
                      S.TrainConfig(total_steps=100, remat=False),
                      "f32 (TF32 off)", 1, refs, pre,
                      want=TRAIN_VIT_H_PER_STEP)
    # remat runs the windows through B1's plain version and B2 twice: in
    # f32 only the summation order differs
    hold(f32, f32_remat, (1e-4, 1e-4), "f32 without remat vs with remat",
         pre, grads=True)
    # every switch rounds bf16 values at other points than the default
    # route (qkv and proj after their bias, B13's MLP): bf16 noise, held to
    # 3x the default route's own distance from f32, and to no less than
    # phase 7's bf16 remat limits
    dist = [abs(first[k] - f32[0][k]) / abs(f32[0][k])
            for k in ("loss", "grad_norm")]
    hold(all_on, (first, None), (max(3 * dist[0], 1e-4),
                                 max(3 * dist[1], 1e-2)),
         "bf16 every switch vs default route", pre)
    del model32, f32_remat, f32, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the rest of inference (calibration, multi-crop AMG, the
# predictor, the full-size golden, beam search, the decoder export)
# ---------------------------------------------------------------------------

# the upstream production AMG config (pred_iou 0.88, stability 0.95, box
# NMS 0.7), 32x32 points in chunks of 256, at most 256 masks
PROD_AMG = dict(points_per_side=32, points_per_batch=256, max_masks=256,
                pred_iou_thresh=0.88, stability_score_thresh=0.95,
                box_nms_thresh=0.7)
# B4-B7's launches in one AMG chunk of 256 prompts
DECODER_CHUNK = {"decode_masks": 1, "two_way_transformer": 1,
                 "upscale_hypernet_stats": 1, "upscale_hypernet": 1}
ENCODE = {"vit_b": {"window_attn": 8, "vit_flash_attn": 4},
          "vit_h": {"window_attn": 28, "vit_flash_attn": 4}}


def _times(d: dict, n: int) -> dict:
    return {k: v * n for k, v in d.items()}


def _plus(*ds: dict) -> dict:
    out = {}
    for d in ds:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def _sweeps(variant: str, n: int, chunks: int = 4) -> dict:
    """The launches of n AMG sweeps (an image or a crop each)."""
    return _times(_plus(ENCODE[variant], _times(DECODER_CHUNK, chunks)), n)


def _calibration_probed(name: str) -> bool:
    """The tensors ``calibrate_amg_weights`` computes from probes; every
    other one it writes is drawn with numpy or set to a constant."""
    return (name.endswith("cross_attn_image_to_token.q_proj.bias")
            or "iou_prediction_head.layers.2." in name
            or ("output_hypernetworks_mlps" in name
                and name.endswith("layers.2.bias")))


def rest_small_reference_check() -> None:
    """(a) ``calibrate_amg_weights`` of a small SAM (a tiny ViT under SAM's
    full-width decoder on the 64x64 embedding; the calibration never runs
    the encoder) on the CPU and on the card from the same weights: the
    drawn and constant tensors bitwise, the probed ones within 1e-4 of
    their largest magnitude (``tests/test_torch_calibrate.py``'s
    tolerance against JAX)."""
    import torch
    from ullsam_tpu_torch.core.config import (MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    from ullsam_tpu_torch.inference.calibrate import calibrate_amg_weights
    from ullsam_tpu_torch.models.sam.sam import Sam
    from ullsam_tpu_torch.ops import layers as L

    cfg = SamConfig(
        vit=ViTConfig(img_size=1024, patch_size=16, embed_dim=64, depth=2,
                      num_heads=2, mlp_ratio=2.0, out_chans=256,
                      window_size=8, global_attn_indexes=(1,)),
        prompt_encoder=PromptEncoderConfig(image_embedding_size=(64, 64),
                                           input_image_size=(1024, 1024),
                                           mask_in_chans=16),
        mask_decoder=MaskDecoderConfig())
    cpu = Sam(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(SEED)
    L.init_module_(cpu, gen)
    gpu = Sam(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ref = calibrate_amg_weights(cpu, cfg).state_dict()
    got = calibrate_amg_weights(gpu, cfg).state_dict()
    worst, exact = 0.0, 0
    for k, v in got.items():
        v = v.cpu()
        if _calibration_probed(k):
            err = float((v - ref[k]).abs().max()) / max(
                float(ref[k].abs().max()), 1e-30)
            worst = max(worst, err)
            if err > 1e-4:
                fail(f"calibration on the card: {k} {err:.3e} from the CPU's"
                     f" (tol 1e-4)")
        elif not torch.equal(v, ref[k]):
            fail(f"calibration on the card: {k} differs from the CPU's")
        else:
            exact += 1
    say(f"[rest] (a) small SAM calibrated on the CPU and on the card: "
        f"{exact} tensors bitwise equal, the probed ones at most "
        f"{worst:.3e} of their largest magnitude apart (tol 1e-4)")


def _match_iou(m16, d16, m32, d32):
    """(bf16 masks, f32 masks kept, common candidates, their mean / min
    mask IoU) of two committed sets matched by candidate index."""
    import numpy as np
    import torch
    common, i16, i32 = np.intersect1d(d16["candidate"], d32["candidate"],
                                      return_indices=True)
    a = m16[torch.from_numpy(i16).cuda()]
    b = m32[torch.from_numpy(i32).cuda()]
    inter = (a & b).sum((1, 2)).float()
    union = (a | b).sum((1, 2)).float().clamp_min(1)
    ious = (inter / union).cpu().numpy()
    return len(common), float(ious.mean()), float(ious.min())


def rest_calibrated_amg(variant: str, images, card: str):
    """(a) ``build_sam(variant)`` calibrated on the card, cast to bf16, the
    production config on 1024x1024 images through ``generate_dense_batch``
    (1 warm, 3 timed, as ``bench_amg_stats`` does), exact launches; one
    f32 image matched to bf16's. Returns (the calibrated f32 and bf16
    models, cfg, the bf16 ms an image)."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
    from ullsam_tpu_torch.inference.calibrate import calibrate_amg_weights
    from ullsam_tpu_torch.models.sam import sam as S
    from ullsam_tpu_torch.models.sam.registry import build_sam

    cfg, model = build_sam(variant, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal32 = calibrate_amg_weights(model, cfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    del model
    cal16 = S.Sam(cfg, device="cuda", dtype=torch.bfloat16)
    cal16.load_state_dict(cal32.state_dict())
    cal16.eval()
    cal32.to("cpu")
    torch.cuda.empty_cache()
    gen16 = AutomaticMaskGenerator(cfg, cal16, **PROD_AMG)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gen16.generate_dense_batch(images[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, f0, c0 = launch_counts(), fused_counts(), c_counts()
    t0 = time.perf_counter()
    res = gen16.generate_dense_batch(images[1:4])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    d = _since(before)
    want = _sweeps(variant, 3)
    df = check_fused(f"calibrated {variant} AMG", f0, 12, True)
    check_f32_kinds(f"calibrated {variant} AMG", d, c0, False)
    counts = [len(data["iou_preds"]) for _, data in res]
    for masks, data in res:
        n = len(data["iou_preds"])
        if (masks.dtype != torch.bool or tuple(masks.shape) != (n, 1024, 1024)
                or not np.isfinite(data["iou_preds"]).all()
                or not (data["iou_preds"] > 0.88).all()
                or not (data["stability"] >= 0.95).all()
                or not (data["areas"] > 0).all()):
            fail(f"calibrated {variant} AMG: masks {tuple(masks.shape)}")
    say(f"[rest] (a) calibrated {variant} (calibration {t_cal:.2f} s on the "
        f"card), bf16, production config 0.88 / 0.95 / NMS 0.7, 3 timed "
        f"images through generate_dense_batch: {counts} masks committed, "
        f"{3 / dt:.3f} images/s ({dt * 1e3 / 3:.1f} ms an image, host "
        f"clock, ends in synchronize), {sum(counts) / dt:.1f} masks/s, peak "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
        f"before (the weights and what earlier phases keep), launches {d},"
        f" fused decoder kernels {df}; {card}")
    if d != want:
        fail(f"calibrated {variant} AMG: launches {d}, expected {want}")
    if min(counts) < 8:
        fail(f"calibrated {variant} AMG committed {counts} masks (at least "
             f"8 an image expected)")
    # one f32 image (TF32 off), matched to bf16's committed masks
    m16, d16 = res[0]
    del res
    cal32.to("cuda")
    gen32 = AutomaticMaskGenerator(cfg, cal32, **PROD_AMG)
    before, f0, c0 = launch_counts(), fused_counts(), c_counts()
    t0 = time.perf_counter()
    m32, d32 = gen32.generate_dense(images[1])
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    d = _since(before)
    check_fused(f"calibrated {variant} AMG f32", f0, 4, False)
    check_f32_kinds(f"calibrated {variant} AMG f32", d, c0, True)
    if d != _sweeps(variant, 1):
        fail(f"calibrated {variant} AMG f32: launches {d}")
    n16, n32 = len(d16["candidate"]), len(d32["candidate"])
    common, mean_iou, min_iou = _match_iou(m16, d16, m32, d32)
    # the population is capped at max_masks, so the two dtypes' IoU
    # predictions rank the last survivors differently: the sets' sizes are
    # held within a tenth, at least 0.7 of the smaller set in common (the
    # readings: 198 of 256 at ViT-B, 192 of 256 at ViT-H), and the masks
    # they share to a mean IoU of 0.99
    say(f"[rest] (a) calibrated {variant}, image 1 in f32 (TF32 off, "
        f"{ms32:.1f} ms, first f32 image): {n32} masks against bf16's "
        f"{n16}, {common} candidates in both (>= 0.7 of the smaller set), "
        f"their mask IoU mean {mean_iou:.5f}, min {min_iou:.5f} (mean >= "
        f"0.99)")
    if abs(n16 - n32) > max(3, n32 // 10) \
            or common < 0.7 * min(n16, n32) or mean_iou < 0.99:
        fail(f"calibrated {variant}: bf16 and f32 committed sets disagree")
    del m16, m32
    return cal32, cal16, cfg, dt * 1e3 / 3


def _crop_order(masks, d):
    """A row order independent of the path: by source crop, iou,
    stability, area, then the full-frame mask's box (bf16 IoU predictions
    and stabilities of 1 tie often)."""
    import numpy as np
    from ullsam_tpu_torch.inference.amg import batched_mask_to_box
    crop = (d["report_crop_boxes"] if "report_crop_boxes" in d
            else d["crop_boxes"])
    box = batched_mask_to_box(masks).cpu().numpy()
    return np.lexsort((*box.T[::-1], d["areas"], d["stability"],
                       d["iou_preds"], *crop.T[::-1]))


def rest_multicrop(cfg, cal16, images, single_ms: float, card: str) -> None:
    """(b) multi-crop AMG on the calibrated ViT-B in bf16: one crop layer
    on 1024x1024 images (1 warm, 2 timed), the device path against the host
    stitch at crop NMS 1.0, one two-layer image of 768x1000 (unequal edge
    crops)."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.inference.amg import (AutomaticMaskGenerator,
                                                generate_crop_boxes)

    gen = AutomaticMaskGenerator(cfg, cal16, crop_n_layers=1, **PROD_AMG)
    gen.generate_dense(images[0])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for img in images[1:3]:
        before, f0 = launch_counts(), fused_counts()
        t0 = time.perf_counter()
        masks, data = gen.generate_dense(img)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        d = _since(before)
        check_fused("multi-crop AMG", f0, 20, True)
        n = len(data["iou_preds"])
        if d != _sweeps("vit_b", 5) or tuple(masks.shape) != (
                n, 1024, 1024) or not 0 < n <= 256 or not np.array_equal(
                    data["areas"], masks.sum((1, 2)).cpu().numpy()):
            fail(f"multi-crop AMG: launches {d}, masks "
                 f"{tuple(masks.shape)}")
        by_crop = {}
        for b in data["report_crop_boxes"].astype(int).tolist():
            by_crop[tuple(b)] = by_crop.get(tuple(b), 0) + 1
    peak = torch.cuda.max_memory_allocated() - held
    boxes1, _ = generate_crop_boxes((1024, 1024), 1, 512 / 1500)
    sizes1 = sorted({(b[3] - b[1], b[2] - b[0]) for b in boxes1[1:]})
    say(f"[rest] (b) calibrated vit_b bf16, crop_n_layers=1 (the full image "
        f"and 4 crops, each swept by its own call, one cross-crop NMS and "
        f"placement on the device), 2 timed 1024x1024 images: "
        f"{', '.join(f'{t:.1f}' for t in lat)} ms (host clock; "
        f"{min(lat) / single_ms:.2f}x the single-crop image's "
        f"{single_ms:.1f} ms), crop sizes {sizes1}, {n} masks, by source crop {by_crop}, "
        f"launches an image {d}, peak {peak / 2**30:.3f} GiB above what "
        f"was held before; {card}")
    del masks
    # the device path against the host stitch, cross-crop NMS off: 8
    # points a side, so every valid candidate of the 5 sweeps (at most
    # 192 each) fits in max_masks and neither path drops one
    kw = dict(PROD_AMG, points_per_side=8, max_masks=1024,
              crop_n_layers=1, crop_nms_thresh=1.0)
    md, dd = AutomaticMaskGenerator(cfg, cal16, **kw).generate_dense(
        images[1])
    mh, dh = AutomaticMaskGenerator(cfg, cal16, device_multicrop=False,
                                    **kw).generate_dense(images[1])
    od, oh = _crop_order(md, dd), _crop_order(mh, dh)
    same = (len(od) == len(oh) and len(od) < 1024
            and np.array_equal(dd["iou_preds"][od], dh["iou_preds"][oh])
            and np.array_equal(dd["areas"][od], dh["areas"][oh])
            and torch.equal(md[torch.from_numpy(od).cuda()],
                            mh[torch.from_numpy(oh).cuda()]))
    say(f"[rest] (b) device path vs host stitch (8 points a side, crop NMS "
        f"1.0): {len(od)} and {len(oh)} masks, iou, areas and placed masks "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        fail("multi-crop AMG: the device path and the host stitch differ")
    del md, mh
    # two layers on 768x1000: unequal edge crops
    img = np.ascontiguousarray(images[3][:768, :1000])
    boxes, _ = generate_crop_boxes((768, 1000), 2, 512 / 1500)
    sizes = {(b[3] - b[1], b[2] - b[0]) for b in boxes[5:]}
    gen2 = AutomaticMaskGenerator(cfg, cal16, crop_n_layers=2, **PROD_AMG)
    before, f0 = launch_counts(), fused_counts()
    t0 = time.perf_counter()
    masks, data = gen2.generate_dense(img)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    d = _since(before)
    n = len(data["iou_preds"])
    check_fused("two-layer AMG", f0, 4 * len(boxes), True)
    inside = True
    for i, (x0, y0, x1, y1) in enumerate(
            data["report_crop_boxes"].astype(int).tolist()):
        outside = masks[i].clone()
        outside[y0:y1, x0:x1] = False
        inside &= not bool(outside.any())
    say(f"[rest] (b) crop_n_layers=2 on a 768x1000 image: {len(boxes)} "
        f"crops (layer-2 sizes {sorted(sizes)}), {ms:.1f} ms, {n} masks, "
        f"launches {d}")
    if len(sizes) < 2 or d != _sweeps("vit_b", len(boxes)) or not inside \
            or tuple(masks.shape) != (n, 768, 1000) or n == 0:
        fail(f"two-layer AMG: {n} masks {tuple(masks.shape)}, launches {d}")
    del masks


def rest_predictor(cfg, cal16, images, card: str) -> None:
    """(c) ``SamPredictor`` on the calibrated ViT-B in bf16: one
    ``set_image`` (B1 8, B2 4), then point, box and point-plus-mask-input
    predictions, each timed, none launching a kernel; an 8x8 grid of
    clicks tracks its prompts as ``tests/test_calibrate.py`` asks (at least
    20 masks, median centroid distance under 15 pixels of the 256x256
    low-res frame, 60 here)."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.inference.amg import build_point_grid
    from ullsam_tpu_torch.inference.predictor import SamPredictor

    pred = SamPredictor(cfg, cal16)
    pred.set_image(images[0])
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    pred.set_image(images[1])
    torch.cuda.synchronize()
    ms_set = (time.perf_counter() - t0) * 1e3
    d = _since(before)
    if d != ENCODE["vit_b"]:
        fail(f"predictor set_image: launches {d}")
    point = dict(point_coords=np.asarray([[300, 420]]),
                 point_labels=np.asarray([1]))
    _, _, low = pred.predict(**point)
    cases = [("point", point),
             ("box", dict(box=np.asarray([200, 250, 600, 700]),
                          multimask_output=False)),
             ("point + mask input", dict(point, mask_input=low[:, :1],
                                         multimask_output=False))]
    lines = []
    for tag, kw in cases:
        pred.predict(**kw)
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, iou, low = pred.predict(**kw)
        ms = (time.perf_counter() - t0) * 1e3
        if _since(before):
            fail(f"predictor {tag}: launched {_since(before)}")
        M = 3 if kw.get("multimask_output", True) else 1
        if masks.shape != (1, M, 1024, 1024) or iou.shape != (1, M) or \
                not np.isfinite(low).all():
            fail(f"predictor {tag}: masks {masks.shape}, iou {iou.shape}")
        lines.append(f"{tag} {ms:.2f} ms")
    errs = []
    for x, y in build_point_grid(8) * 1024:
        masks, _, _ = pred.predict(point_coords=np.asarray([[x, y]]),
                                   point_labels=np.asarray([1]))
        ys, xs = np.nonzero(masks[0, 0])
        if len(xs):
            errs.append(float(np.hypot(xs.mean() - x, ys.mean() - y)))
    say(f"[rest] (c) SamPredictor on the calibrated vit_b, bf16: set_image "
        f"{ms_set:.1f} ms (launches {d}), predict (host clock, masks to the "
        f"host): {', '.join(lines)}, no kernel launched; 64 grid clicks: "
        f"{len(errs)} masks, median centroid distance "
        f"{float(np.median(errs)) if errs else float('nan'):.1f} px; {card}")
    if len(errs) < 20 or float(np.median(errs)) > 60.0:
        fail("predictor: the calibrated masks do not track their clicks")


def rest_export(cfg, cal32, card: str) -> None:
    """(f) the full decoder exported from the calibrated ViT-B (f32), loaded
    back on the card, against the eager decoder function: within 1e-5 of
    max|eager| (the same ops), no kernel launched."""
    import torch
    from ullsam_tpu_torch.inference.export import (export_decoder,
                                                   load_exported_decoder,
                                                   make_onnx_decoder_fn)

    orig = (768, 1000)
    t0 = time.perf_counter()
    blob = export_decoder(cal32, cfg, num_points=3, batch=2, full=True,
                          return_single_mask=True, orig_im_size=orig)
    fn = load_exported_decoder(blob)
    t_exp = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    args = (torch.randn(1, 64, 64, 256, generator=gen, device="cuda"),
            torch.rand(2, 3, 2, generator=gen, device="cuda") * 1024,
            torch.tensor([[1, 0, -1], [1, 1, -1]], device="cuda"),
            torch.randn(2, 256, 256, 1, generator=gen, device="cuda"),
            torch.tensor([1.0, 0.0], device="cuda"))
    eager = make_onnx_decoder_fn(cfg, return_single_mask=True,
                                 orig_im_size=orig)
    before = launch_counts()
    with torch.no_grad():
        ref = eager(cal32, *args)
    got = fn(*args)
    ms_got = cuda_time_ms(lambda: fn(*args), 5)
    with torch.no_grad():
        ms_ref = cuda_time_ms(lambda: eager(cal32, *args), 5)
    errs = [_rel(g, r) for g, r in zip(got, ref)]
    say(f"[rest] (f) exported decoder (torch.export, {len(blob) / 2**20:.2f} "
        f"MiB, traced and loaded in {t_exp:.1f} s) on the card against the "
        f"eager function: upscaled, scores, low-res {', '.join(f'{e:.2e}' for e in errs)} "
        f"of max|eager| (tol 1e-5), {ms_got:.3f} ms against {ms_ref:.3f} ms "
        f"(CUDA events); {card}")
    if _since(before) or max(errs) > 1e-5 or got[0].shape != (2, 1) + orig:
        fail(f"exported decoder: errors {errs}, launches {_since(before)}")


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def rest_golden(card: str) -> None:
    """(d) ``tests/goldens/sam_vitb_full``: SAM ViT-B at full width on the
    weights of ``tools/synth_weights.py`` against the PyTorch reference's
    outputs, through B1 and B2 on the card: float32 (split TF32) at the
    CPU test's tolerances (embedding 5e-3, iou 2e-3, low-res 5e-2, each
    mask's IoU >= 0.99) and bfloat16 at ``tests/test_flagship_parity.py``'s
    contract (confident pixels agree >= 0.999, each mask's IoU >= 0.98)."""
    import numpy as np
    import torch
    from tools.synth_weights import manifest_from_arrays, synth_state_dict
    from ullsam_tpu_torch.convert.from_jax import load_reference_state_dict
    from ullsam_tpu_torch.core.config import sam_vit_b
    from ullsam_tpu_torch.models.sam import sam as S

    with np.load("tests/goldens/sam_vitb_full.npz") as z:
        g = {k: z[k] for k in z.files}
    cfg = sam_vit_b()
    sd = synth_state_dict(manifest_from_arrays(g["manifest_keys"],
                                               g["manifest_shapes"]))
    image = (np.random.RandomState(123).rand(3, 786, 1024) * 255
             ).astype(np.float32).transpose(1, 2, 0)
    ref_masks = np.unpackbits(g["masks_packed"]).astype(bool)[
        :int(np.prod(g["masks_shape"]))].reshape(g["masks_shape"])
    ref_emb = torch.from_numpy(np.transpose(g["emb"].astype(np.float32),
                                            (0, 2, 3, 1))).cuda()
    ref_low = torch.from_numpy(g["low_res"].astype(np.float32)).cuda()
    ref_logits = S.postprocess_masks(ref_low, (786, 1024), (768, 1000), cfg)
    confident = (ref_logits.abs() > 0.02 * ref_logits.std()).cpu().numpy()
    for dtype in (torch.float32, torch.bfloat16):
        sam = load_reference_state_dict(
            S.Sam(cfg, device="cuda", dtype=dtype), sd).eval()
        before = launch_counts()
        with torch.no_grad():
            x = S.preprocess(torch.from_numpy(np.ascontiguousarray(
                image)).cuda()[None], cfg).to(dtype)
            emb = S.encode_image(sam.image_encoder, x)
            low, iou = S.decode_masks(
                sam.prompt_encoder, sam.mask_decoder, emb,
                points=(torch.from_numpy(g["coords"]).cuda(),
                        torch.from_numpy(g["labels"]).cuda()),
                multimask_output=True)
            final = S.postprocess_masks(low, (786, 1024), (768, 1000), cfg)
        d = _since(before)
        binary = (final > cfg.mask_threshold).cpu().numpy()
        ious = [float(np.logical_and(binary[0, m], ref_masks[0, m]).sum()
                      / max(np.logical_or(binary[0, m], ref_masks[0, m])
                            .sum(), 1)) for m in range(3)]
        e_emb = float((emb.float() - ref_emb).abs().max())
        e_iou = float(np.abs(iou.float().cpu().numpy() - g["iou"]).max())
        e_low = float(((low.float() - ref_low).abs() - 5e-2 * ref_low.abs())
                      .max())
        agree = float((binary == ref_masks)[confident].mean())
        tag = "f32" if dtype == torch.float32 else "bf16"
        say(f"[rest] (d) sam_vitb_full golden, {tag} on the card: embedding "
            f"max diff {e_emb:.3e}, iou {e_iou:.3e}, low-res max(|diff| - "
            f"5e-2 |ref|) {e_low:.3e}, mask IoU "
            f"{', '.join(f'{v:.5f}' for v in ious)}, confident-pixel "
            f"agreement {agree:.5f}, launches {d}")
        if d != ENCODE["vit_b"]:
            fail(f"golden {tag}: launches {d}")
        ok = (e_emb <= 5e-3 and e_iou <= 2e-3 and e_low <= 5e-2
              and min(ious) >= 0.99) if tag == "f32" else (
                  agree >= 0.999 and min(ious) >= 0.98)
        if not ok:
            fail(f"golden {tag}: outside the stated tolerances")
        del sam


def rest_beam_search(card: str) -> None:
    """(e) ``beam_search`` on the flagship InternLM2-1.8B (random bf16
    weights from the seed) on the fusion's 1152-token image prompt, 4
    beams and 32 new tokens, in bf16 and then int8 (``quantize_llm_int8``):
    one beam equals ``caption_ids``' greedy tokens up to greedy's first
    eos; four beams score at least greedy's log-probability, both scored by
    one forward, less the spread measured between that forward and the
    search's own bf16 incremental scores; B12's
    launches exact in int8 (121 a pass: the prefill and each of the 31
    steps), none in bf16; a step's time from a 32-token and a 1-token
    call."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.internlm2 import model as LLM
    from ullsam_tpu_torch.models.internlm2.generate import (GenerationConfig,
                                                            beam_search)
    from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import caption_inputs

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    model = F.build_ullsam(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    lm = model.fusion.language_model
    pixels, ids, mask = caption_inputs(cfg, np.random.default_rng(SEED))
    T = 32
    mask_d = torch.as_tensor(mask).cuda().int()

    def logprob(embeds, toks):
        """The continuation's log-probability under one forward over the
        prompt and the tokens (through the first eos)."""
        toks = toks.tolist()
        if cfg.llm.eos_token_id in toks:
            toks = toks[:toks.index(cfg.llm.eos_token_id) + 1]
        t = torch.tensor([toks], device="cuda")
        with torch.inference_mode():
            x = torch.cat([embeds, LLM.embed_tokens(lm, t).to(embeds.dtype)],
                          1)
            m = torch.cat([mask_d, torch.ones_like(t, dtype=torch.int32)], 1)
            lg = LLM.internlm2_forward(lm, cfg.llm, inputs_embeds=x,
                                       attention_mask=m)["logits"]
            lp = torch.log_softmax(lg[0, embeds.shape[1] - 1:-1].float(), -1)
            return float(lp.gather(1, t[0][:, None]).sum())

    for kind in ("bf16", "int8"):
        if kind == "int8":
            quantize_llm_int8(lm)
            torch.cuda.empty_cache()
        b12 = B12_PER_PASS if kind == "int8" else 0
        greedy, _ = chat.caption_ids(model, cfg, pixels, ids, mask,
                                     gen=GenerationConfig(max_new_tokens=T))
        greedy = greedy[0].cpu()
        with torch.inference_mode():
            embeds = chat.embeds_with_image(
                model, cfg, torch.as_tensor(ids).cuda().long(),
                torch.as_tensor(pixels).cuda().float())
        one, score1 = beam_search(lm, cfg.llm, embeds, mask_d,
                                  num_beams=1, max_new_tokens=T)
        beam_search(lm, cfg.llm, embeds, mask_d, num_beams=4,
                    max_new_tokens=T)                       # warm
        ms = {}
        for n in (1, T):
            before = launch_counts()
            k12 = b12_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, score = beam_search(lm, cfg.llm, embeds, mask_d,
                                      num_beams=4, max_new_tokens=n)
            torch.cuda.synchronize()
            ms[n] = (time.perf_counter() - t0) * 1e3
            d = _since(before)
            want = {"w8a16_matmul": b12 * n} if b12 else {}
            # the prefill at the prompt's rows, then n - 1 steps at 4 beams
            d12 = {k: v - k12[k] for k, v in b12_counts().items()
                   if v != k12[k]}
            want12 = _plus_counts(b12_pass(ids.shape[1]),
                                  b12_pass(4, times=n - 1)) if b12 else {}
            if d != want or d12 != want12:
                fail(f"beam search {kind}, {n} new tokens: launches {d}, "
                     f"B12 kernels {d12}, expected {want}, {want12}")
        step = (ms[T] - ms[1]) / (T - 1)
        eos = cfg.llm.eos_token_id
        one = one.cpu()
        lp_beam, lp_greedy, lp_one = (logprob(embeds, t) for t in
                                      (toks.cpu(), greedy, one))

        def length(t):
            """The scored length: through the first eos, else all T."""
            t = t.tolist()
            return t.index(eos) + 1 if eos in t else T

        # the search scores in bf16 step by step (a sum of log-probs over
        # the length, length_penalty 1), the check by one forward: the
        # slack is that disagreement, measured on both searches' tokens
        slack = (abs(lp_beam - float(score) * length(toks.cpu()))
                 + abs(lp_one - float(score1) * length(one)))
        # a search keeps an eos candidate apart and extends its best other
        # token, so one beam follows greedy up to greedy's first eos (all
        # T tokens when greedy emits none)
        upto = length(greedy) - 1 if eos in greedy.tolist() else T
        same = upto > 0 and torch.equal(one[:upto], greedy[:upto])
        say(f"[rest] (e) beam_search {kind}, flagship InternLM2-1.8B on the "
            f"1152-token image prompt ({int(mask.sum())} valid), 4 beams, "
            f"{T} new tokens: {ms[T]:.1f} ms ({ms[1]:.1f} ms with 1 token: "
            f"prefill and the first top-k), {step:.3f} ms a step (host "
            f"clock); score {float(score):.4f}; log-prob by one forward: "
            f"beams {lp_beam:.4f}, greedy {lp_greedy:.4f} (beams >= greedy - "
            f"{slack:.4f}, the spread measured between one forward and the "
            f"searches' own scores); one beam equals caption_ids' greedy "
            f"tokens over their first {upto}: {same}; launches a 32-token "
            f"call {d}; {card}")
        if toks.shape != (T,) or not np.isfinite(float(score)):
            fail(f"beam search {kind}: tokens {tuple(toks.shape)}")
        if lp_beam < lp_greedy - slack:
            fail(f"beam search {kind}: beams {lp_beam} below greedy "
                 f"{lp_greedy} - {slack}")
        if not same:
            fail(f"beam search {kind}: one beam {one.tolist()} differs from "
                 f"greedy {greedy.tolist()} over the first {upto} tokens")
    del model, lm
    torch.cuda.empty_cache()


def rest_main_path() -> None:
    """Phase 13: the calibrated production AMG at ViT-B (with multi-crop,
    the predictor and the export on its weights) and ViT-H, the full-size
    golden, beam search."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.tools.main_path import amg_inputs

    card = smi_line()
    images = amg_inputs(np.random.default_rng(SEED + 13), 4)
    cal32, cal16, cfg, single_ms = rest_calibrated_amg("vit_b", images,
                                                       card)
    rest_multicrop(cfg, cal16, images, single_ms, card)
    rest_predictor(cfg, cal16, images, card)
    rest_export(cfg, cal32, card)
    del cal32, cal16
    torch.cuda.empty_cache()
    cal32, cal16, _, _ = rest_calibrated_amg("vit_h", images, card)
    del cal32, cal16
    torch.cuda.empty_cache()
    rest_golden(card)
    rest_beam_search(card)


# ---------------------------------------------------------------------------
# phase 14: the training and evaluation CLIs
# ---------------------------------------------------------------------------

# ``python -m ullsam_tpu_torch.train.cli`` at its defaults (f32, remat) in
# segment mode with the Hungarian matching over 2 epochs of 4 images
CLI_SEG = ["--mode", "segment", "--grad_accum", "2", "--instance_matching",
           "hungarian", "--max_steps", "8", "--log_every", "1",
           "--image_log_every", "4", "--ckpt_every", "1000"]
# its launches: 8 micro-steps with remat (B2 8, B9 4 each) and 2 overlay
# forwards (B1 8, B2 4 each)
CLI_SEG_LAUNCHES = {"vit_flash_attn": 8 * 8 + 2 * 4, "vit_flash_attn_bwd": 32,
                    "window_attn": 16}
CLI_SFT = ["--mode", "sft", "--pack", "--max_length", "2560",
           "--param_dtype", "bfloat16", "--max_steps", "2", "--epochs", "1",
           "--grad_accum", "2", "--log_every", "1"]


def cli_dataset(root: str, n: int = 4, size: int = 1024) -> str:
    """``n`` random RGB PNGs (size x size) under root/images, instance maps
    of 3 or 4 discs under root/masks, and a jsonl of SFT rows
    ({image_path, conversation}); returns the jsonl's path."""
    import os
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 14)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub))
    yy, xx = np.mgrid[:size, :size]
    rows = []
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        m = np.zeros((size, size), np.uint8)
        for j in range(3 + i % 2):
            cx, cy = rng.integers(size // 6, size - size // 6, 2)
            r = int(rng.integers(size // 16, size // 7))
            m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = j + 1
        path = os.path.join(root, "images", f"{i}.png")
        Image.fromarray(img).save(path)
        Image.fromarray(m).save(os.path.join(root, "masks", f"{i}.png"))
        rows.append({"image_path": path, "conversation": [
            {"role": "user", "content": "Describe the image.\n<image>"},
            {"role": "assistant", "content": "Cells on a plate."}]})
    jsonl = os.path.join(root, "data.jsonl")
    with open(jsonl, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return jsonl


def cli_metrics(out_dir: str) -> list:
    import os
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def _timed_steps(clock: list):
    """A ``train.step.make_train_step`` that records, for each step of a
    CLI run, (host ms since the previous step ended, host ms of the step
    ending in synchronize): the first is what the loop spends outside the
    step (waiting on ``PrefetchIterator``, ``batch_on``, logging)."""
    import torch
    from ullsam_tpu_torch.train import step as S
    make = S.make_train_step

    def make_timed(*a, **kw):
        inner = make(*a, **kw)
        last = [time.perf_counter()]

        def step(batch):
            t0 = time.perf_counter()
            out = inner(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            clock.append(((t0 - last[0]) * 1e3, (t1 - t0) * 1e3))
            last[0] = t1
            return out
        return step
    return make, make_timed


def _busy_ms(fn) -> tuple:
    """(host ms, device busy ms) of one ``fn()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += dev / 1e3
    return wall, busy


def _trainable(model) -> dict:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters() if p.requires_grad}


def cli_segment(tmp: str, data: str, card: str) -> str:
    """(b) the segment CLI run, its direct-step hold and its resume hold;
    returns the path of a reference-named .pt of the run's final model."""
    import os
    import numpy as np
    import torch
    from ullsam_tpu_torch.data import tokenizer as tok
    from ullsam_tpu_torch.data.datasets import (DatasetConfig, SegDataset,
                                                batch_iterator_sharded)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.train import cli as TCLI
    from ullsam_tpu_torch.train import step as S

    clock = []
    make, S.make_train_step = _timed_steps(clock)

    def run(name, *flags):
        out = os.path.join(tmp, name)
        before, c0 = launch_counts(), c_counts()
        t = time.perf_counter()
        model = TCLI.main(CLI_SEG + ["--data_path", data, "--output_dir",
                                    out, *flags])
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v - before[k]}
        return out, model, (time.perf_counter() - t) * 1e3, d, c0

    try:
        out, model, ms, d, c0 = run("seg", "--epochs", "2")
    finally:
        S.make_train_step = make
    check_f32_kinds("cli segment", d, c0, True)
    rows = cli_metrics(out)
    if [r["step"] for r in rows] != list(range(1, 9)) or len(clock) != 8:
        fail(f"cli segment: steps {[r['step'] for r in rows]}, "
             f"{len(clock)} timed")
    for r, (gap, step_ms) in zip(rows, clock):
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"cli segment: non-finite metrics {r}")
        say(f"[cli] segment step {r['step']}: loss {r['loss']:.6f}, "
            f"grad_norm {r['grad_norm']:.6f}, iou {r['iou']:.4f}, "
            f"batch_time {r['batch_time'] * 1e3:.1f} ms (the CLI's timer), "
            f"step {step_ms:.1f} ms and {gap:.1f} ms before it outside the "
            f"step (host clock)")
    images = os.listdir(os.path.join(out, "logs", "images"))
    say(f"[cli] segment run (SAM ViT-B + InternLM2-1.8B, f32, remat, "
        f"--grad_accum 2, hungarian, 8 micro-steps, 2 epochs of 4 "
        f"1024x1024 images): {ms:.0f} ms in all (build, data, steps, 2 "
        f"overlays, 2 checkpoints); launches {d}; overlay images {images}; "
        f"{card}")
    if d != CLI_SEG_LAUNCHES or len(images) != 2:
        fail(f"cli segment: launches {d}, expected {CLI_SEG_LAUNCHES}; "
             f"images {images}")
    loop = [g + s for g, s in clock[1:]]
    final = _trainable(model)
    cfg = model.cfg
    pt = os.path.join(tmp, "ullsam.pt")
    t = time.perf_counter()
    torch.save({(k[len("fusion."):] if k.startswith("fusion.") else k):
                v.to("cpu") for k, v in model.state_dict().items()}, pt)
    say(f"[cli] final model saved as a reference-named .pt "
        f"({os.path.getsize(pt) / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t:.1f} s")
    del model
    torch.cuda.empty_cache()

    # the direct step: train/step.py on the epoch's first example, from
    # the seed's weights, as the CLI built them
    saved = launch_counts()
    tcfg = S.TrainConfig(total_steps=8, instance_matching="hungarian")
    model = F.build_ullsam(cfg, device="cuda", seed=SEED)
    opt = S.make_trainable_optimizer(model, tcfg, grad_accum=2)
    step = S.make_train_step(cfg, tcfg, model, opt)
    dcfg = DatasetConfig(data_path=data, img_size=cfg.sam.vit.img_size,
                         num_image_token=cfg.num_image_token)
    batch = next(batch_iterator_sharded(
        SegDataset(dcfg, tok.load_tokenizer()), 1, seed=0, epoch=0))
    batch = S.batch_on(model, batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = {k: float(v) for k, v in step(batch).items()}
    direct_ms = (time.perf_counter() - t) * 1e3
    wall, busy = _busy_ms(lambda: step(batch))
    _restore_counts(saved)
    del model, opt, step
    torch.cuda.empty_cache()
    errs = [abs(m[k] - rows[0][k]) / abs(rows[0][k])
            for k in ("loss", "grad_norm")]
    say(f"[cli] direct train/step.py step on the same example from the same "
        f"weights: loss {m['loss']:.6f} (CLI {rows[0]['loss']:.6f}, rel "
        f"{errs[0]:.2e}), grad_norm {m['grad_norm']:.6f} (CLI "
        f"{rows[0]['grad_norm']:.6f}, rel {errs[1]:.2e}); rtol 1e-4 each")
    if max(errs) > 1e-4:
        fail("cli segment: step 1 disagrees with the direct step")
    steps = [s for _, s in clock[1:]]
    gaps = [g for g, _ in clock[1:]]
    say(f"[cli] step time: direct step {direct_ms:.1f} ms (host clock, its "
        f"first call), profiled again {wall:.1f} ms with {busy:.1f} ms "
        f"device busy ({100 * busy / wall:.1f}%); CLI micro-steps 2-8: step "
        f"mean {np.mean(steps):.1f} ms; outside it median "
        f"{np.median(gaps):.1f} ms, mean {np.mean(gaps):.1f}, max "
        f"{max(gaps):.1f} (step {2 + int(np.argmax(gaps))}: after an "
        f"overlay, a checkpoint or an epoch's first batch); a loop "
        f"iteration median {np.median(loop):.1f} ms, mean "
        f"{np.mean(loop):.1f}, so the device is busy "
        f"{100 * busy / np.median(loop):.1f}% of a median iteration and "
        f"{100 * busy / np.mean(loop):.1f}% of the mean; {card}")

    # resume at the epoch boundary: --epochs 1, then --epochs 2 --resume
    saved = launch_counts()
    clock.clear()
    make, S.make_train_step = _timed_steps(clock)
    try:
        out1, model, _, _, _ = run("resumed", "--epochs", "1")
        del model
        out2, model, _, _, _ = run("resumed", "--epochs", "2", "--resume")
    finally:
        S.make_train_step = make
    _restore_counts(saved)
    resumed = _trainable(model)
    del model
    torch.cuda.empty_cache()
    got = cli_metrics(out2)
    if [r["step"] for r in got] != list(range(1, 9)):
        fail(f"cli resume: steps {[r['step'] for r in got]}")
    step_errs = [max(abs(g[k] - r[k]) / abs(r[k]) for k in ("loss",
                                                           "grad_norm"))
                 for g, r in zip(got, rows)]
    worst, name = grad_gap(final, resumed)
    same = all(torch.equal(final[n], resumed[n]) for n in final)
    say(f"[cli] resume at the epoch boundary (--epochs 1, then --epochs 2 "
        f"--resume) vs the straight run: per-step loss / grad_norm worst rel "
        f"{max(step_errs):.2e} (rtol 1e-4); {len(final)} final trainable "
        f"tensors, worst {worst:.2e} of max|param| ({name}; tol 1e-3), "
        f"bitwise equal: {same}")
    if max(step_errs) > 1e-4 or worst > 1e-3:
        fail("cli resume: the resumed run disagrees with the straight one")
    return pt


def cli_sft(tmp: str, data: str, card: str) -> None:
    """(c) ``--mode sft --pack --max_length 2560 --param_dtype bfloat16``,
    2 steps of one packed row of two samples each: B10 and B11 launch
    exactly as phase 8's packed step asks."""
    import os
    import numpy as np
    import torch
    from ullsam_tpu_torch.train import cli as TCLI

    before = launch_counts()
    out = os.path.join(tmp, "sft")
    t = time.perf_counter()
    model = TCLI.main(CLI_SFT + ["--data_path", data, "--output_dir", out])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    d = {k: v - before[k] for k, v in launch_counts().items()
         if v - before[k]}
    dtype = next(model.parameters()).dtype
    del model
    torch.cuda.empty_cache()
    rows = cli_metrics(out)
    for r in rows:
        say(f"[cli] sft --pack step {r['step']}: loss {r['loss']:.6f}, "
            f"grad_norm {r['grad_norm']:.6f}, batch_time "
            f"{r['batch_time'] * 1e3:.1f} ms")
    want = {k: 2 * v for k, v in PACKED_PER_STEP.items()}
    say(f"[cli] sft --pack run ({dtype}, 2 packed rows of 2560 tokens): "
        f"{ms:.0f} ms in all; launches {d}; {card}")
    if ([r["step"] for r in rows] != [1, 2] or dtype != torch.bfloat16
            or not all(np.isfinite(r["loss"]) for r in rows) or d != want):
        fail(f"cli sft: steps {rows}, dtype {dtype}, launches {d}, expected "
             f"{want}")


def cli_eval(tmp: str, data: str, pt: str, card: str) -> None:
    """(d) ``python -m ullsam_tpu_torch.eval.cli`` in the modes seg,
    seg_amg and lm, ``--limit 2``, on (b)'s .pt: every summary value
    finite; the masks of the first image's seg run bitwise equal to direct
    ``chat.point_segment`` calls on the same model."""
    import numpy as np
    import torch
    from PIL import Image
    from ullsam_tpu_torch.convert import reference as R
    from ullsam_tpu_torch.convert.from_jax import load_reference_state_dict
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.data import tokenizer as tok
    from ullsam_tpu_torch.data.datasets import (DatasetConfig, SegDataset,
                                                load_instance_map)
    from ullsam_tpu_torch.eval import cli as ECLI
    from ullsam_tpu_torch.eval.seg_metrics import instances_to_masks
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.models.ullsam import fusion as F

    seen = []
    point_segment = chat.point_segment

    def recording(*a, **kw):
        out = point_segment(*a, **kw)
        seen.append((a[4], out[0].cpu()))
        return out

    for mode in ("seg", "seg_amg", "lm"):
        before = launch_counts()
        t = time.perf_counter()
        chat.point_segment = recording
        try:
            summary = ECLI.main(["--mode", mode, "--data_path", data,
                                 "--checkpoint", pt, "--limit", "2"])
        finally:
            chat.point_segment = point_segment
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v - before[k]}
        say(f"[cli] eval {mode} (--limit 2): {ms:.0f} ms in all, summary "
            f"{json.dumps(summary, sort_keys=True)}, launches {d}; {card}")
        if not summary or not all(np.isfinite(v) for v in summary.values()):
            fail(f"cli eval {mode}: summary {summary}")
        if mode == "seg_amg" and not all(d.get(k) for k in (
                "window_attn", "vit_flash_attn", "decode_masks",
                "two_way_transformer", "upscale_hypernet_stats")):
            fail(f"cli eval seg_amg: launches {d}")

    # the first image's masks against direct calls, from the same .pt
    saved = launch_counts()
    model = F.build_ullsam(FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b()),
                           device="cuda", seed=0)
    load_reference_state_dict(model, R.convert_fusion_state_dict(
        R.load_torch_state_dict(pt)))
    cfg = model.cfg
    row = SegDataset(DatasetConfig(data_path=data), tok.load_tokenizer()
                     ).rows[0]
    size = cfg.sam.vit.img_size
    pixel = np.asarray(Image.open(row["image_path"]).convert("RGB")
                       .resize((size, size)))
    gt = instances_to_masks(load_instance_map(
        row["image_path"].replace("images", "masks"), size))
    dense, feats = chat.segment_forward(model, cfg, tok.load_tokenizer(),
                                        pixel.astype(np.float32)[None]
                                        / 255.0)
    same = []
    for g, (clicks, mask) in zip(gt, seen):
        ys, xs = np.nonzero(g)
        want = np.asarray([[[float(xs.mean()), float(ys.mean())]]],
                          np.float32)
        m, _, _ = chat.point_segment(model, cfg, feats, dense, want,
                                     np.asarray([[1]], np.int64))
        same.append(np.array_equal(np.asarray(clicks), want)
                    and torch.equal(m.cpu(), mask))
    _restore_counts(saved)
    del model
    torch.cuda.empty_cache()
    say(f"[cli] eval seg, image 0: {len(gt)} masks from the CLI against "
        f"direct point_segment calls, bitwise equal: {same}")
    if len(same) != len(gt) or not all(same):
        fail("cli eval: the CLI's masks differ from direct point_segment")


def cli_main_path() -> None:
    """Phase 14: the train CLI (segment with --grad_accum 2 and the
    Hungarian matching, its direct-step and resume holds; sft --pack in
    bf16) and the eval CLI (seg, seg_amg, lm) at full width (SAM ViT-B +
    InternLM2-1.8B, random weights from the seed) on a synthetic dataset
    of 4 1024x1024 PNGs, with phase 12's stub tokenizer."""
    import os
    import tempfile
    import torch
    from ullsam_tpu_torch.data import tokenizer as tok

    card = smi_line()
    stub = StubTokenizer()
    load = tok.load_tokenizer
    tok.load_tokenizer = lambda path=None: stub
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = cli_dataset(os.path.join(tmp, "data"))
            pt = cli_segment(tmp, data, card)
            cli_sft(tmp, data, card)
            cli_eval(tmp, data, pt, card)
    finally:
        tok.load_tokenizer = load
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 15: data and tensor parallelism, image-parallel AMG, host ops
# ---------------------------------------------------------------------------

DP_RTOL = 1e-4       # dp 2 step's loss and grad norm against one process's
# the tp 2 engine's first logits against batch-1 tp 1 ``caption_ids``'
# (relative L2): bf16 at these random weights moves about 1e-2 under
# another left padding alone (phase 12's reading), and tp 2 rounds each
# rank's partial products to bf16 before their sum
TP_LOGIT_RTOL = 5e-2
TP_NEW = 32          # new tokens of a tp 2 engine request
PARALLEL_RANKS: dict = {}   # the rank processes' launches, summed


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _all_counts() -> dict:
    """Every launch counter: the wrappers', the C-counted kernels' and the
    fused decoder kernels'."""
    return {**launch_counts(), **c_counts(), **fused_counts()}


def _uncounted(fn):
    """``fn()`` with every launch counter set back afterwards: reference
    runs do not count on a path."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.ops.kernels import gemm as G
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    counters = {**kernel_wrappers(), "gemm_sm90": G.gemm_sm90,
                "gemm_mma": G.gemm_mma, "gemm_sm90_f32": G.gemm_sm90_f32,
                "gemm_fma": G.gemm_fma, "window_core_f32": WA.window_core_f32,
                **D.FUSED_KERNELS, "decoder_gemm_f32": D.decoder_gemm_f32}
    saved = {k: c.launches for k, c in counters.items()}
    try:
        return fn()
    finally:
        for k, c in counters.items():
            c.launches = saved[k]


def _run_ranks(case: str, world: int, workdir: str, inputs: dict,
               timeout: float = 600.0) -> list:
    """``world`` processes of ``chip_smoke.py --parallel-rank CASE`` on
    cuda:0 over one gloo group (a file store in ``workdir``); fails, with
    the rank's log, if any exits non-zero or outlives ``timeout`` (the
    others are killed). Echoes the ranks' ``[parallel]`` lines and adds
    their launch counts to PARALLEL_RANKS. Returns each rank's output."""
    import os

    import torch
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--parallel-rank", case, str(r), str(world), workdir],
                stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("[parallel]"):
                say(line)
        if p.returncode:
            fail(f"parallel {case}: rank {r} exited {p.returncode}:\n"
                 f"{text[-4000:]}")
    outs = [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]
    for o in outs:
        for k, v in o["counts"].items():
            PARALLEL_RANKS[k] = PARALLEL_RANKS.get(k, 0) + v
    return outs


def _flagship():
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    return FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())


def _dp_batch(cfg):
    """Two flagship train rows (``train_batch`` twice from the seed)."""
    import numpy as np
    from ullsam_tpu_torch.tools.main_path import train_batch
    rng = np.random.default_rng(SEED)
    rows = [train_batch(cfg, rng) for _ in range(2)]
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def _two_steps(cfg, model, batch, tag: str):
    """Two f32 steps (no remat) of a fresh optimizer: (metrics of each,
    the step-1 gradients, the trainable weights after step 2), each step
    with exactly TRAIN_PER_STEP launches."""
    import torch
    from ullsam_tpu_torch.train import step as S
    tc = S.TrainConfig(total_steps=100, remat=False)
    opt = S.make_trainable_optimizer(model, tc)
    st = S.make_train_step(cfg, tc, model, opt)
    batch = S.batch_on(model, batch)
    out, grads = [], None
    for i in (1, 2):
        m, ms, d = _step_launches(st, batch, True, f"{tag} step {i}")
        if d != TRAIN_PER_STEP:
            fail(f"{tag} step {i}: launches {d}, expected {TRAIN_PER_STEP}")
        out.append((m, ms))
        if i == 1:
            grads = {n: p.grad.detach().clone()
                     for n, p in zip(opt.names, opt.params)
                     if p.grad is not None}
    weights = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    return out, grads, weights


def parallel_world_one(cfg, model, start, batch1) -> None:
    """(1) One rank over NCCL: the f32 step through the new code (a 1 x 1
    mesh with its process groups: the global loss denominators, the
    gradient and metric all-reduces) bitwise the direct step, two steps
    from the same weights."""
    import torch
    from ullsam_tpu_torch.parallel import distributed as D
    from ullsam_tpu_torch.parallel import partitioning as P
    D.initialize(init_method=f"tcp://127.0.0.1:{_free_port()}",
                 world_size=1, rank=0, device="cuda")
    try:
        mesh = P.create_mesh(1, 1)
        if mesh.backend != "nccl" or mesh.data_group is None:
            fail(f"parallel: world size 1 mesh {mesh}")
        direct = _two_steps(cfg, model, batch1, "parallel direct")
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in start:
                    p.copy_(start[n])
        P.shard_params(model, mesh)
        meshed = _two_steps(cfg, model, batch1, "parallel mesh 1x1")
    finally:
        model.mesh = None
        D.shutdown()
    same_m = all(a[0] == b[0] for a, b in zip(direct[0], meshed[0]))
    same_g = all(torch.equal(direct[1][n], meshed[1][n]) for n in direct[1])
    same_w = all(torch.equal(direct[2][n], meshed[2][n]) for n in direct[2])
    say(f"[parallel] world size 1 over NCCL, f32 flagship step through the "
        f"dp / tp code against the direct step: metrics bitwise {same_m}, "
        f"{len(direct[1])} step-1 gradients bitwise {same_g}, trainable "
        f"weights after step 2 bitwise {same_w}; step ms direct "
        f"{[round(x[1], 1) for x in direct[0]]}, mesh "
        f"{[round(x[1], 1) for x in meshed[0]]}")
    if not (same_m and same_g and same_w):
        fail("parallel: the 1 x 1 mesh step is not bitwise the direct step")


def parallel_dp2(cfg, model, start, workdir: str) -> None:
    """(2) dp 2 on one card: two gloo ranks on cuda:0, one row each, against
    one process's step on both rows."""
    import torch
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in start:
                p.copy_(start[n])
    batch = _dp_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ref, ref_grads, _ = _two_steps(cfg, model, batch, "parallel dp ref")
    ref_peak = torch.cuda.max_memory_allocated() - base
    ref_grads = {n: g.cpu() for n, g in ref_grads.items()}
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(g.numel() for g in ref_grads.values())
    del model
    torch.cuda.empty_cache()
    # reckoning: f32 weights, then gradients and two moments of the
    # trainable ones, then one row's activations (about half the
    # one-process step's two rows)
    reckon = (4 * n_all + 12 * n_train) / 2**30 + ref_peak / 2 / 2**30
    say(f"[parallel] dp 2: {n_all / 1e9:.3f} B f32 parameters, "
        f"{n_train / 1e6:.1f} M trainable; reckoned per rank about "
        f"{reckon:.1f} GiB (weights {4 * n_all / 2**30:.1f}, gradients and "
        f"moments {12 * n_train / 2**30:.2f}, activations of one row about "
        f"{ref_peak / 2 / 2**30:.1f}); the one-process step on 2 rows: "
        f"{ref[0][1]:.1f} / {ref[1][1]:.1f} ms, peak {ref_peak / 2**30:.2f} "
        f"GiB above its start")
    outs = _run_ranks("dp", 2, workdir, {"batch": batch})
    for r, o in enumerate(outs):
        for i in (0, 1):
            got, want = o["metrics"][i], ref[i][0]
            errs = {k: abs(got[k] - want[k]) / abs(want[k])
                    for k in ("loss", "grad_norm")}
            say(f"[parallel] dp 2 rank {r} step {i + 1}: loss "
                f"{got['loss']:.6f} (rel {errs['loss']:.2e}), grad_norm "
                f"{got['grad_norm']:.6f} (rel {errs['grad_norm']:.2e}), "
                f"{o['ms'][i]:.1f} ms; peak {o['peak'] / 2**30:.2f} GiB")
            if max(errs.values()) > DP_RTOL:
                fail(f"parallel dp 2 rank {r} step {i + 1}: {errs} above "
                     f"{DP_RTOL}")
    worst, name = grad_gap(ref_grads, outs[0]["grads"])
    say(f"[parallel] dp 2: {len(ref_grads)} step-1 gradients (the mean over "
        f"the ranks) against one process's, worst {worst:.2e} of max|grad| "
        f"({name}; tol 1e-3)")
    if worst > 1e-3 or set(outs[0]["grads"]) != set(ref_grads):
        fail("parallel dp 2: gradients disagree")
    same = outs[0]["hashes"] == outs[1]["hashes"]
    say(f"[parallel] dp 2: the ranks' {len(outs[0]['hashes'])} trainable "
        f"tensors bitwise equal after step 2: {same}")
    if not same:
        fail("parallel dp 2: the ranks' weights differ after the update")


def _tp_refs(model, cfg, prompts: dict, quant) -> dict:
    """Batch-1 ``caption_ids`` (tp 1) of each prompt: name -> (tokens
    through the first EOS, f32 logits of each step [n, V]); uncounted."""
    import copy

    import torch
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
    from ullsam_tpu_torch.models.ullsam import chat
    gen = GenerationConfig(max_new_tokens=TP_NEW,
                           eos_token_id=SPECIAL_IDS["<|im_end|>"],
                           pad_token_id=StubTokenizer.pad_token_id)
    lm = model.fusion.language_model
    if quant:
        model.fusion.language_model = quantize_llm_int8(copy.deepcopy(lm))
    refs = {}
    try:
        for name, (ids, pixels) in prompts.items():
            steps = []
            toks, lens = _uncounted(lambda: chat.caption_ids(
                model, cfg, pixels, *chat.left_pad([ids], gen.pad_token_id),
                gen, step_hook=lambda i, lg: steps.append(lg[0].float())))
            refs[name] = (toks[0, :int(lens[0])].tolist(),
                          torch.stack(steps).cpu())
    finally:
        model.fusion.language_model = lm
    torch.cuda.synchronize()
    return refs


def _tp_check(tag: str, refs: dict, got: dict) -> None:
    """The engine's first logits within TP_LOGIT_RTOL (relative L2) of the
    reference's; its tokens equal up to the first step whose reference
    top-2 gap is under TP_LOGIT_RTOL of that step's logits' RMS."""
    for name, (toks, steps) in refs.items():
        first = got["first"][name]
        rel = _rel_l2(first, steps[0])
        top2 = steps.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / steps.pow(2).mean(-1).sqrt()
        close = (gap < TP_LOGIT_RTOL).nonzero()
        k = int(close[0]) if len(close) else len(toks)
        mine = got["tokens"][name]
        same = mine[:k] == toks[:k]
        say(f"[parallel] tp 2 engine {tag} {name}: first logits relative L2 "
            f"{rel:.3e} (tol {TP_LOGIT_RTOL}), {len(mine)} tokens, equal to "
            f"tp 1 through step {k} (the first top-2 gap under the tol: "
            f"{'none' if k == len(toks) else f'step {k}'}): {same}")
        if rel > TP_LOGIT_RTOL or not same:
            fail(f"parallel tp 2 engine {tag} {name}: first logits rel "
                 f"{rel:.3e} or tokens {mine[:k]} vs {toks[:k]}")


def parallel_tp_amg(card: str, workdir: str):
    """(3) The tp 2 engine at full width and (4) image-parallel AMG, in one
    pair of gloo ranks on cuda:0. Returns rank 0's AMG masks of image 0
    (bit-packed) for the host ops."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.models.ullsam import fusion as F
    cfg = _flagship()
    model = F.build_ullsam(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (1, 1024, 1024, 3), dtype=np.uint8)
    tk = StubTokenizer()
    from ullsam_tpu_torch.models.ullsam.conversation import build_chat_prompt
    prompts = {
        "image": (tk.encode(build_chat_prompt(
            cfg.template, SERVE_IMAGE_Q, num_image_token=cfg.num_image_token,
            has_image=True)), img),
        "text": (tk.encode(build_chat_prompt(
            cfg.template, SERVE_TEXT_QS[0],
            num_image_token=cfg.num_image_token, has_image=False)), None)}
    scaled = {k: (ids, None if pv is None else pv.astype(np.float32) / 255)
              for k, (ids, pv) in prompts.items()}
    refs = {q: _tp_refs(model, cfg, scaled, q) for q in ("int8", None)}
    del model
    torch.cuda.empty_cache()
    outs = _run_ranks("tp_amg", 2, workdir, {"prompts": prompts})
    for quant in ("int8", None):
        tag = quant or "bf16"
        got = outs[0][tag]
        _tp_check(tag, refs[quant], got)
        new = sum(len(t) for t in got["tokens"].values())
        b12 = [o[tag]["b12"] for o in outs]
        say(f"[parallel] tp 2 engine {tag}: chunks {outs[0][tag]['mode']}, "
            f"{new} tokens of 2 concurrent requests (one image) in "
            f"{got['ms']:.1f} ms after a warm round = "
            f"{new / got['ms'] * 1e3:.1f} tok/s, decode alone "
            f"{got['decode_tok_s']:.1f} tok/s (a gloo all-reduce of the "
            f"[2, 1, 2048] bf16 activations takes "
            f"{outs[0]['allreduce_ms']:.3f} ms, 48 a decode step); B12 "
            f"launches per rank "
            f"{b12} ({got['b12_want']} expected over both rounds: 121 a "
            f"decode step, 120 a prefill segment and 1 for a prompt's head); "
            f"{card}")
        if quant and b12 != [got["b12_want"]] * 2:
            fail(f"parallel tp 2 int8: B12 launches {b12}, expected "
                 f"{got['b12_want']} on each rank")
        k12 = [o[tag]["b12_kernels"] for o in outs]
        say(f"[parallel] tp 2 engine {tag}: B12 kernels per rank {k12}")
        if k12 != [got["b12_kernels_want"]] * 2:
            fail(f"parallel tp 2 {tag}: B12 kernels {k12}, expected "
                 f"{got['b12_kernels_want']} on each rank")
        if not quant and any(b12):
            fail(f"parallel tp 2 bf16 launched B12 {b12}")
    amg = outs[0]["amg"]
    say(f"[parallel] AMG 2 ranks x 1 image (ViT-B bf16, 1024x1024, 32x32 "
        f"points): {amg['masks']} masks committed, each rank's outputs "
        f"bitwise its single-image sweep: {amg['same']}; sweep ms per rank "
        f"{[round(o['amg_ms'], 1) for o in outs]}; launches per rank "
        f"{[o['amg_launches'] for o in outs]}; {card}")
    if not amg["same"]:
        fail("parallel AMG: a rank's masks differ from its single-image "
             "sweep")
    for o in outs:
        if o["amg_launches"] != _sweeps("vit_b", 1):
            fail(f"parallel AMG launches {o['amg_launches']}, expected "
                 f"{_sweeps('vit_b', 1)}")
    return amg["packed"]


def parallel_host_ops(packed, card: str) -> None:
    """(5) The native host ops against numpy / scipy on the 256 masks of
    one ViT-B AMG image, on this machine's CPU: RLE bitwise, the
    8-connected labelling bitwise scipy's (and ``remove_small_regions``
    bitwise on the first 16 masks, islands and holes), the IoU matrix
    within one float32 ulp; each timed both ways, the IoU with its peak
    host memory (tracemalloc)."""
    import tracemalloc

    import numpy as np
    from scipy import ndimage
    from ullsam_tpu_torch.eval.seg_metrics import _mask_iou_numpy
    from ullsam_tpu_torch.inference.amg import (_mask_to_rle_numpy,
                                                _remove_small_regions,
                                                remove_small_regions)
    from ullsam_tpu_torch.native import host_ops
    if not host_ops.available():
        fail(f"native host ops did not load: {host_ops.load_error()}")
    masks = np.unpackbits(packed, axis=-1)[..., :1024].astype(bool)
    masks = masks.reshape(-1, 1024, 1024)

    def timed(fn):
        tracemalloc.start()
        t = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t) * 1e3
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        return out, ms, peak

    eight = np.ones((3, 3))
    r1 = timed(lambda: host_ops.mask_to_rle(masks))
    r0 = timed(lambda: _mask_to_rle_numpy(masks))
    c1 = timed(lambda: [host_ops.connected_components(m) for m in masks])
    c0 = timed(lambda: [ndimage.label(m, structure=eight) for m in masks])
    i1 = timed(lambda: host_ops.mask_iou_matrix(masks, masks))
    i0 = timed(lambda: _mask_iou_numpy(masks, masks))
    rle_same = r1[0] == r0[0]
    comp_same = all(a[1] == b[1] and np.array_equal(a[0], b[0])
                    for a, b in zip(c1[0], c0[0]))
    few = masks[:16]
    small_same = all(np.array_equal(
        _remove_small_regions(m, 100, mode,
                              host_ops.connected_components)[0],
        remove_small_regions(m, 100, mode)[0])
        for m in few for mode in ("islands", "holes"))
    ulps = int(np.abs(i1[0].view(np.int32).astype(np.int64)
                      - i0[0].view(np.int32).astype(np.int64)).max())
    n_comp = sum(n for _, n in c1[0])
    say(f"[parallel] host ops on {len(masks)} AMG masks of 1024x1024 "
        f"(this machine's CPU): RLE native {r1[1]:.1f} ms, numpy "
        f"{r0[1]:.1f} ms, counts equal {rle_same}; 8-connected labelling "
        f"native {c1[1]:.1f} ms, scipy {c0[1]:.1f} ms, {n_comp} components, "
        f"labels bitwise {comp_same} (remove_small_regions bitwise on "
        f"{len(few)} masks, islands and holes: {small_same}); IoU "
        f"{len(masks)}x"
        f"{len(masks)} native {i1[1]:.1f} ms (peak {i1[2] / 2**20:.1f} MiB "
        f"host), numpy {i0[1]:.1f} ms (peak {i0[2] / 2**20:.1f} MiB), "
        f"{ulps} ulp apart at most; {card}")
    if not (rle_same and comp_same and small_same and ulps <= 1):
        fail("parallel: native host ops disagree with numpy / scipy")


def parallel_main_path() -> None:
    """Phase 15: (1) world size 1 over NCCL, (2) dp 2, (3) the tp 2
    engine, (4) image-parallel AMG, (5) the host ops."""
    import tempfile

    import numpy as np
    import torch
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import train_batch
    card = smi_line()
    t0 = time.perf_counter()
    from ullsam_tpu_torch.train import step as S
    cfg = _flagship()
    model = F.build_ullsam(cfg, device="cuda", seed=SEED)
    trains = S.trainable_mask(model, S.TrainConfig())
    start = {n: p.detach().clone() for n, p in model.named_parameters()
             if trains[n]}
    batch1 = train_batch(cfg, np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        parallel_world_one(cfg, model, start, batch1)
        parallel_dp2(cfg, model, start, f"{tmp}/dp")
        del model, start
        torch.cuda.empty_cache()
        packed = parallel_tp_amg(card, f"{tmp}/tp_amg")
    parallel_host_ops(packed, card)
    say(f"[parallel] phase 15 took {time.perf_counter() - t0:.1f} s")


def _rank_dp(inp: dict, rank: int) -> dict:
    import hashlib

    import torch
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.parallel import partitioning as P
    cfg = _flagship()
    model = F.build_ullsam(cfg, device="cuda", seed=SEED)
    mesh = P.create_mesh(dp=2, tp=1)
    P.shard_params(model, mesh)
    torch.cuda.reset_peak_memory_stats()
    steps, grads, weights = _two_steps(cfg, model,
                                       P.shard_batch(inp["batch"], mesh),
                                       f"parallel dp rank {rank}")
    return {"metrics": [s[0] for s in steps], "ms": [s[1] for s in steps],
            "peak": torch.cuda.max_memory_allocated(),
            "grads": ({n: g.cpu() for n, g in grads.items()} if rank == 0
                      else None),
            "hashes": {n: hashlib.sha256(w.cpu().numpy().tobytes())
                       .hexdigest() for n, w in weights.items()}}


def _rank_engine(model, cfg, mesh, prompts, quant, rank) -> dict:
    """One tp 2 engine: rank 0 submits both prompts at once, a warm round
    of 4 new tokens and then a timed one of TP_NEW, and waits; the other
    rank serves. Each rank's B12 launches over both rounds."""
    import torch
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.serve.engine import GenerationEngine
    b0 = w8a16_launches()
    k0 = b12_counts()
    eng = GenerationEngine(model, cfg, StubTokenizer(), max_batch=4,
                           max_len=2560, prefill_chunk=256,
                           steps_per_dispatch=8, quant=quant,
                           gen=GenerationConfig(max_new_tokens=TP_NEW),
                           device="cuda", mesh=mesh)
    out = {"mode": eng.chunk_mode}
    if rank:
        eng.wait(timeout=SERVE_TIMEOUT)
        out["b12"] = w8a16_launches() - b0
        out["b12_kernels"] = {k: v - k0[k] for k, v in b12_counts().items()
                              if v != k0[k]}
        return out
    for new in (4, TP_NEW):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reqs = {k: eng.submit_ids(ids, pv, new)
                for k, (ids, pv) in prompts.items()}
        for k, r in reqs.items():
            if not r.event.wait(SERVE_TIMEOUT) or r.error is not None:
                fail(f"tp 2 engine request {k}: {r.error}")
        out["ms"] = (time.perf_counter() - t) * 1e3
    eng.shutdown()
    out["tokens"] = {k: r.tokens for k, r in reqs.items()}
    out["first"] = {k: r.first_logits.float().cpu() for k, r in reqs.items()}
    first = min(r.t_first for r in reqs.values())
    last = max(r.t_done for r in reqs.values())
    out["decode_tok_s"] = (sum(len(r.tokens) - 1 for r in reqs.values())
                           / (last - first))
    # B12 a prompt: 120 a segment (5 linears x 24 layers), the head once on
    # the last segment's last row; 121 a decode step; two rounds
    want = 121 * int(eng.phase_stats["steps"])
    steps = int(eng.phase_stats["steps"])
    if quant:  # by kernel: steps at the 4 slots' rows, segments, heads
        want12 = [b12_pass(4, B12_TP2_LINEARS, steps)]
    for ids, _ in prompts.values():
        chunk = min(256, -(-len(ids) // 128) * 128)
        segs = -(-len(ids) // chunk)
        want += 2 * (120 * segs + 1)
        if quant:
            want12 += [b12_pass(chunk, B12_TP2_LINEARS[:4], 2 * segs),
                       b12_pass(1, B12_TP2_LINEARS[4:], 2)]
    out["b12_want"] = want
    out["b12"] = w8a16_launches() - b0
    out["b12_kernels"] = {k: v - k0[k] for k, v in b12_counts().items()
                          if v != k0[k]}
    out["b12_kernels_want"] = _plus_counts(*want12) if quant else {}
    return out


def w8a16_launches() -> int:
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    return Q.w8a16_matmul.launches


def _rank_tp_amg(inp: dict, rank: int) -> dict:
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import sam_vit_b
    from ullsam_tpu_torch.inference import amg as A
    from ullsam_tpu_torch.models.sam.sam import Sam
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.parallel import partitioning as P
    from ullsam_tpu_torch.tools.main_path import amg_inputs
    cfg = _flagship()
    mesh = P.create_mesh(dp=1, tp=2)
    model = F.build_ullsam(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
    # what a tp 2 decode step waits on 48 times (2 a layer): one gloo
    # all-reduce of a [2, 1, 2048] bf16 CUDA tensor, staged through the host
    x = torch.ones((2, 1, 2048), dtype=torch.bfloat16, device="cuda")
    for _ in range(10):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    out = {"allreduce_ms": (time.perf_counter() - t) * 10}
    # int8 first: it quantizes whole weights, then shards the model
    for quant in ("int8", None):
        out[quant or "bf16"] = _rank_engine(model, cfg, mesh, inp["prompts"],
                                            quant, rank)
    del model
    torch.cuda.empty_cache()
    # image-parallel AMG: one image a rank, the shared 32x32 grid
    scfg = sam_vit_b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sam32 = Sam(scfg, device="cuda")
    L.init_module_(sam32, gen)
    sam = Sam(scfg, device="cuda", dtype=torch.bfloat16)
    sam.load_state_dict(sam32.state_dict())
    del sam32
    images = np.stack(amg_inputs(np.random.default_rng(SEED), 2))
    pts = (A.build_point_grid(32) * 1024).astype(np.float32)
    kw = dict(points_per_batch=256, max_out=256)
    with torch.no_grad():
        A.amg_sharded_sweep(sam, scfg, images, pts, **kw)    # warm
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = A.amg_sharded_sweep(sam, scfg, images, pts, **kw)
        torch.cuda.synchronize()
        out["amg_ms"] = (time.perf_counter() - t) * 1e3
        out["amg_launches"] = {k: v - before[k] for k, v in
                               launch_counts().items() if v != before[k]}
        if rank == 0:
            ref = _uncounted(lambda: [A.amg_device_sweep(
                sam, scfg, torch.from_numpy(images[d:d + 1]).cuda(),
                torch.from_numpy(pts).cuda(), pred_iou_thresh=0.0,
                stability_thresh=0.0, stability_offset=1.0,
                box_nms_thresh=1.0, input_hw=(1024, 1024),
                out_hw=(1024, 1024), n_real=len(pts), **kw)
                for d in range(2)])
            same = all(torch.equal(got[k][d], r[k])
                       for d, r in enumerate(ref) for k in r)
            out["amg"] = {"same": same,
                          "masks": int(got["valid"].sum()),
                          "packed": np.packbits(
                              got["masks"][0].cpu().numpy(), axis=-1)}
    return out


RANK_CASES = {"dp": _rank_dp, "tp_amg": _rank_tp_amg}


def parallel_rank(argv) -> None:
    """The entry of a phase-15 rank process: ``chip_smoke.py
    --parallel-rank CASE RANK WORLD WORKDIR`` (gloo on cuda:0, a file
    store in WORKDIR; the kernels come from the parent's build)."""
    import os

    import torch
    from ullsam_tpu_torch.ops.kernels import build
    from ullsam_tpu_torch.parallel import distributed as D
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.cuda.set_device(0)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    D.initialize(init_method="file://" + os.path.join(workdir, "store"),
                 world_size=world, rank=rank, backend="gloo", device="cuda")
    reset_counts()
    out = RANK_CASES[case](inp, rank)
    out["counts"] = _all_counts()
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    D.barrier()
    D.shutdown()


# every path in the order the run drives it
PATHS = {"interactive": main_path, "amg": amg_main_path,
         "train": train_main_path, "packed": packed_main_path,
         "caption": caption_main_path, "vit_h": vit_h_main_path,
         "train_vit_h": train_vit_h_main_path, "serve": serve_main_path,
         "rest": rest_main_path, "cli": cli_main_path,
         "parallel": parallel_main_path}


def main() -> None:
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(sys.argv[2:])
    t_start = time.perf_counter()
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
    rows.update(check_train_kernels(smi))
    rows.update(check_llm_kernels(smi))
    rows.update(check_w8a16_kernel(smi))
    rows = check_vit_h_kernels(smi, rows)
    rows.update(check_gemm_kernel(smi))
    # the f32 window core's own row: its B3 reading at ViT-H (hd 80)
    core = rows["window_attn_core"]["vit_h_float32"]
    rows["window_core_f32"] = {
        "name": "window_core_f32", "route": "cuda",
        "source": "ullsam_tpu_torch/csrc/window_core_f32.cuh",
        "replaces": "ullsam_tpu/ops/pallas/flash_attention.py:1033",
        "carries": "the f32 core of B1 (vit_block.py:203), B3 and B15 "
                   "(flash_attention.py:1064), split TF32", **core}
    small_reference_check()
    amg_small_reference_check()
    train_small_reference_check()
    train_small_reference_check(hd=80)
    packed_small_reference_check()
    caption_small_reference_check()
    vit_h_small_reference_check()
    serve_small_reference_check()
    rest_small_reference_check()
    by_path, gemm_by_path, fused_by_path = {}, {}, {}
    for path, drive in PATHS.items():
        reset_counts()
        PARALLEL_RANKS.clear()
        drive()
        # the path's launches: this process's and its rank processes'
        ranks = PARALLEL_RANKS
        by_path[path] = {k: v + ranks.get(k, 0)
                         for k, v in launch_counts().items()}
        gemm_by_path[path] = {k: v + ranks.get(k, 0)
                              for k, v in c_counts().items()}
        for k in ("gemm_sm90", "gemm_sm90_f32", "window_core_f32"):
            by_path[path][k] = gemm_by_path[path][k]
        fused_by_path[path] = {k: v + ranks.get(k, 0)
                               for k, v in fused_counts().items()}
        say(f"[main] launches on the {path} path: {by_path[path]}; "
            f"C-counted kernels {gemm_by_path[path]}")
    launches = {name: sum(c[name] for c in by_path.values()) for name in rows}
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    # the fused kernels inside B4-B7 (bf16 and float32); those of an AMG
    # chunk launched on the AMG paths (the upscale without statistics is
    # B7's alone, which an AMG chunk does not call)
    for name, row in rows["decode_masks"]["fused"].items():
        row["launches_by_path"] = {p: c[name]
                                   for p, c in fused_by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"] and (name in FUSED_PER_CHUNK
                                    or name in FUSED_PER_CHUNK_F32):
            fail(f"fused decoder kernel {name} never launched on a path")
    # the serve path's CUDA graphs: a replay runs B12 without passing
    # through the wrapper, so ``launches`` holds the eager launches alone;
    # beside them the chunks and steps replayed and B12's launches a decode
    # step in the keys' warm-ups
    rows["w8a16_matmul"]["serve_graphs"] = SERVE
    say(f"[main] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": list(rows.values())}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
