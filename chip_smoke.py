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
 7. the segmentation train step: a small uLLSAM trained one f32 step on the
    CPU (plain versions) and on the card (kernels) from the same weights
    and batch, loss and every gradient compared; then the flagship (SAM
    ViT-B + frozen InternLM2-1.8B) at full width in bfloat16 without remat,
    1 warm and 3 timed steps on the batch of
    benchmarks/bench_train_step.py, then from the same starting weights a
    float32 step with remat, two float32 steps and two bfloat16 steps with
    remat; step 1 with remat is held to step 1 without it in loss and grad
    norm (float32: rtol 1e-4 each; bfloat16: 1e-4 and 1e-2).
 8. packed LLM fine-tuning (``--mode sft --pack --max_length 2560``): B10
    and B11 against their plain versions at the path's shapes (phase 3's
    checks); a small uLLSAM whose LLM has head dim 128, one f32 sft step on
    a packed row of S = 2560 (the real B10 dispatch) on the CPU (plain
    versions) and on the card (kernels), loss within 1e-5 relative and
    every gradient within 1e-3 of its max; then the flagship at full width
    in bfloat16 (the LLM, mlp1 and mlp2 train, SAM frozen, remat on), 1 warm
    and 3 timed steps on one packed row of two samples (1124 + 1224 tokens,
    two images), with exact launches per step, and one bfloat16
    interactive segment_prefill with a 2560-token prompt.
 9. caption generation with the int8 weight-only LLM: B12 against its plain
    version at every shape of InternLM2-1.8B's linears on the caption path:
    decode at batch 1 and 8, prefill of the 1152-token prompt at batch 1
    and 8 (M = 1152, 9216), bf16 and f32 (phase 3's checks; decode with the
    weight cold in L2); a small uLLSAM with its LLM quantized, 16 greedy
    tokens of ``caption_ids`` with an image on the CPU (plain versions) and
    on the card (kernels), tokens identical and each step's logits within
    1e-4 of their max; then the flagship at full width in bfloat16
    (``caption_ids``, 256 new tokens, 1024 image + 64 text tokens padded to
    1152): 1 warm + 1 timed request and a left-padded batch of 8, then with
    ``quantize_llm_int8``, 1 warm + 3 timed and a batch of 8, each with
    prefill and per-step decode times, tokens/s, peak memory and exact
    launches (int8: B12 121 a decode step and in the prefill; bf16: none).
10. SAM ViT-H automatic mask generation: B1, B2 and B3 at head dim 80 and
    the opt-in kernels B13 (fused LN + MLP), B14 (global attention read
    from the qkv projection) and B15 (two-phase window attention) against
    their plain versions at ViT-H's shapes (B13-B15 at ViT-B's too), bf16
    and f32 (phase 3's checks); a small encoder with head dim 80 on the CPU
    (plain versions) and on the card (kernels) under each route setting of
    the JAX package's switches (default, ULLSAM_FUSED_VIT_MLP=1,
    ULLSAM_PACKED_GLOBAL=1, ULLSAM_FUSED_VIT_ATTN=0, and that with
    ULLSAM_WINDOW_TWOPHASE=1), f32 within 1e-4 of max|out|, exact launches;
    then ``build_sam("vit_h")`` at full width (random weights from the
    seed) on 1024x1024 images, the deterministic sweep: bf16 1 warm + 3
    timed images with exact launches (B1 28, B2 4, B4-B7 4 an image), one
    f32 image; the encode alone under each route setting (1 warm + 5 timed,
    exact launches, each bf16 embedding against the default route's), and
    one bf16 image with all four switches on (B13 32, B14 4, B15 28).
Each path (5-10) runs with every launch counter set to 0 just before it and
read just after. Then the kernels JSON line (``launches``: the sum
over the paths; ``launches_by_path``: each path's own count), the
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


TRAIN_KERNELS = (
    ("window_attn_core", "ullsam_tpu_torch/csrc/window_attn.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:1033"),
    ("window_attn_core_bwd", "ullsam_tpu_torch/csrc/window_attn_bwd.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:1194"),
    ("vit_flash_attn_bwd", "ullsam_tpu_torch/csrc/vit_flash_bwd.cu",
     "ullsam_tpu/ops/pallas/flash_attention.py:812"))


def _sdpa_ms(q, k, v, bias, backward: bool, **kw) -> float:
    """The library yardstick: scaled_dot_product_attention with the bias
    (or boolean mask) materialized; with ``backward`` the time of forward +
    backward (every float input, a float bias included, requiring grad)
    less the forward's. ``kw`` goes to the call (``enable_gqa``)."""
    import torch
    import torch.nn.functional as F
    ins = [t.detach().requires_grad_(backward and t.is_floating_point())
           for t in (q, k, v, bias)]

    def fwd():
        return F.scaled_dot_product_attention(ins[0], ins[1], ins[2],
                                              attn_mask=ins[3], **kw)
    t_fwd = cuda_time_ms(fwd, iters=5, warmup=1)
    if not backward:
        return t_fwd
    g = torch.randn_like(q)

    def fwd_bwd():
        torch.autograd.grad(fwd(), [t for t in ins if t.requires_grad], g)
    return cuda_time_ms(fwd_bwd, iters=5, warmup=1) - t_fwd


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
                f"(relative to max|plain|; tol {tol[dtype]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
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
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
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
    compared (lse on the rows that have a valid key). The bound counts the
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
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
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


def small_config():
    """A small uLLSAM that every ViT kernel takes: hd = 64, a padded 16x16
    grid in 14x14 windows, one global block; a 2-layer LLM."""
    from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    return FusionConfig(
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
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
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


# ---------------------------------------------------------------------------
# phase 7: the segmentation train step
# ---------------------------------------------------------------------------

TRAIN_PER_STEP = {"window_attn": 8, "window_attn_core": 8,
                  "window_attn_core_bwd": 8, "vit_flash_attn": 4,
                  "vit_flash_attn_bwd": 4}


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


def train_small_reference_check() -> None:
    """One f32 train step of the small uLLSAM on the CPU (plain versions)
    and on the card (B1, B3, B8, B2, B9) from the same weights and batch:
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

    cfg = small_config()
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
    say(f"[train] small uLLSAM, one f32 step, CPU plain vs card kernels: "
        f"loss {float(m_c['loss']):.6f} vs {float(m_g['loss']):.6f} (rel "
        f"{rel_loss:.2e}), grad_norm {float(m_c['grad_norm']):.6f} vs "
        f"{float(m_g['grad_norm']):.6f}; {len(g_c)} gradient tensors, worst "
        f"{worst:.2e} of max|grad| ({worst_name}); card launches {d_g}")
    if rel_loss > 1e-4 or worst > 1e-3 or set(g_c) != set(g_g):
        fail("small train step: the card and the CPU disagree")


def train_main_path() -> None:
    """SAM ViT-B + InternLM2-1.8B at full width (random weights from the
    seed), bfloat16 parameters and moments, remat off: 1 warm and 3 timed
    steps on the flagship batch; then, from the same starting weights, a
    float32 step with remat, two float32 steps and two bfloat16 steps with
    remat, step 1 with remat held to step 1 without it (``hold``)."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import train_batch
    from ullsam_tpu_torch.train import step as S

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
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
    say(f"[train] flagship bf16: {n_all / 1e9:.3f} B params, "
        f"{n_train / 1e6:.1f} M trainable, weights {weights / 2**30:.3f} "
        f"GiB, moments {moments / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    step = S.make_train_step(cfg, tcfg, model16, opt)
    batch = S.batch_on(model16, batch)  # device-resident, as a loader's

    def run(tag):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v - before[k]}
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(list(vals.values()))):
            fail(f"train {tag}: non-finite metrics {vals}")
        say(f"[train] bf16 {tag}: {ms:.1f} ms (host clock, ends in "
            f"synchronize), loss {vals['loss']:.6f}, grad_norm "
            f"{vals['grad_norm']:.6f}, iou {vals['iou']:.4f}, launches {d}")
        return ms, vals, d

    torch.cuda.reset_peak_memory_stats()
    _, first, _ = run("step 1 (warm, lr 0)")
    snap = [p.detach().clone() for p in opt.params]
    timed = [run(f"step {i}") for i in (2, 3, 4)]
    peak = torch.cuda.max_memory_allocated()
    for _, _, d in timed:
        if d != TRAIN_PER_STEP:
            fail(f"train launches per step {d}, expected {TRAIN_PER_STEP}")
    moved = sum(not torch.equal(a, p) for a, p in zip(snap, opt.params))
    same = all(torch.equal(a, p.detach().cpu())
               for a, p in zip(frozen, llm.parameters()))
    say(f"[train] bf16: {moved} of {len(snap)} trainable tensors moved "
        f"over steps 2-4; frozen LLM weights bit-identical: {same}")
    if not moved or not same:
        fail("train: trainable weights did not move or frozen ones did")
    lat = [t[0] for t in timed]
    say(f"[train] bf16 flagship step (SAM ViT-B + InternLM2-1.8B, b=1, "
        f"1088 tokens, 4 instances x 2 points, 1024x1024 masks, remat off):"
        f" {', '.join(f'{x:.1f}' for x in lat)} ms, mean "
        f"{sum(lat) / 3:.1f} ms; peak {peak / 2**30:.3f} GiB, so "
        f"{(peak - weights - moments) / 2**30:.3f} GiB above weights and "
        f"moments")
    del model16, opt, step, snap, frozen, llm
    torch.cuda.empty_cache()

    def steps(model, tc, tag, n):
        """Steps 1 (lr 0, so the weights stay as they were) to ``n`` of a
        fresh optimizer, each printed beside the bf16 step of its number;
        returns the metrics and the gradients of step 1."""
        opt = S.make_trainable_optimizer(model, tc)
        st = S.make_train_step(cfg, tc, model, opt)
        out = None
        for i in range(1, n + 1):
            before = launch_counts()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = {k: float(v) for k, v in st(batch).items()}
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            d = {k: v - before[k] for k, v in launch_counts().items()
                 if v - before[k]}
            if not all(np.isfinite(list(m.values()))):
                fail(f"train {tag}: non-finite metrics")
            ref = first if i == 1 else second
            say(f"[train] {tag} step {i}: {ms:.1f} ms, loss {m['loss']:.6f}"
                f" ({m['loss'] - ref['loss']:+.2e} vs bf16 step {i}), "
                f"grad_norm {m['grad_norm']:.6f} "
                f"({m['grad_norm'] - ref['grad_norm']:+.2e}), peak "
                f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} "
                f"GiB above the step's start, launches {d}")
            out = out or (m, {name: p.grad.detach().clone()
                              for name, p in zip(opt.names, opt.params)
                              if p.grad is not None})
        return out

    def hold(got, ref, rtols, what, grads=False):
        """Fail unless ``got``'s loss and grad norm are within ``rtols``
        (loss, grad norm) of ``ref``'s, relative, and, with ``grads``, each
        gradient tensor within 1e-3 as in ``grad_gap``."""
        errs = [abs(got[0][k] - ref[0][k]) / abs(ref[0][k])
                for k in ("loss", "grad_norm")]
        msg = (f"[train] {what}, step 1: loss rel {errs[0]:.2e} (rtol "
               f"{rtols[0]:g}), grad_norm rel {errs[1]:.2e} (rtol "
               f"{rtols[1]:g})")
        bad = any(e > t for e, t in zip(errs, rtols))
        if grads:
            worst, name = grad_gap(ref[1], got[1])
            msg += (f"; {len(ref[1])} gradient tensors, worst {worst:.2e} "
                    f"of max|grad| ({name}; tol 1e-3)")
            bad = bad or worst > 1e-3 or set(got[1]) != set(ref[1])
        say(msg)
        if bad:
            fail(f"train: {what} disagree at step 1")

    second = timed[0][1]
    remat = S.TrainConfig(total_steps=100, remat=True)
    # all from the starting weights (the f32 model's remat step has lr 0;
    # its step 2 without remat moves its own weights, last)
    model16 = F.ULLSAM(cfg, device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    model32.to("cuda")
    f32_remat = steps(model32, remat, "f32 (TF32 off) with remat", 1)
    f32 = steps(model32, tcfg, "f32 (TF32 off)", 2)
    # remat runs the windowed blocks through B1's plain version and the
    # global blocks' B2 twice: in f32 only the summation order differs
    hold(f32_remat, f32, (1e-4, 1e-4), "f32 remat vs no remat", grads=True)
    del model32, f32_remat, f32
    torch.cuda.empty_cache()
    # in bf16 the plain version rounds as B1 does but flips roundings where
    # the two sum in another order; the bf16 step's own distance from the
    # f32 step (printed above: about 3e-6 in loss, 4e-3 in grad norm) is
    # the scale of that noise
    hold(steps(model16, remat, "bf16 with remat", 2), (first, None),
         (1e-4, 1e-2), "bf16 remat vs no remat")


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


def packed_main_path() -> None:
    """SAM ViT-B + InternLM2-1.8B at full width (random weights from the
    seed), bfloat16 parameters and moments, the sft settings (the LLM,
    mlp1 and mlp2 train, SAM frozen, remat on): 1 warm and 3 timed steps on
    one packed row (S = 2560: 1124 + 1224 tokens, two 1024x1024 images);
    then one bfloat16 segment_prefill with a 2560-token prompt."""
    import numpy as np
    import torch
    from ullsam_tpu_torch.core.config import (FusionConfig, internlm2_1_8b,
                                              sam_vit_b)
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.tools.main_path import (SFT_TRAIN,
                                                  packed_train_batch,
                                                  request_inputs)
    from ullsam_tpu_torch.train import step as S

    cfg = FusionConfig(sam=sam_vit_b(), llm=internlm2_1_8b())
    t0 = time.perf_counter()
    model = F.build_ullsam(cfg, device="cuda", dtype=torch.bfloat16,
                           seed=SEED)
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
    say(f"[packed] flagship bf16 sft: {n_train / 1e9:.3f} B trainable "
        f"(LLM, mlp1, mlp2) of {n_all / 1e9:.3f} B, weights "
        f"{weights / 2**30:.3f} GiB, moments {moments / 2**30:.3f} GiB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    step = S.make_train_step(cfg, tcfg, model, opt)
    batch = S.batch_on(model, packed_train_batch(
        cfg, np.random.default_rng(SEED)))

    def run(tag):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v - before[k]}
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(list(vals.values()))):
            fail(f"packed {tag}: non-finite metrics {vals}")
        say(f"[packed] bf16 {tag}: {ms:.1f} ms (host clock, ends in "
            f"synchronize), loss {vals['loss']:.6f}, grad_norm "
            f"{vals['grad_norm']:.6f}, launches {d}")
        return ms, d

    torch.cuda.reset_peak_memory_stats()
    run("step 1 (warm, lr 0)")
    snap = [p.detach().clone() for p in opt.params]
    timed = [run(f"step {i}") for i in (2, 3, 4)]
    peak = torch.cuda.max_memory_allocated()
    for _, d in timed:
        if d != PACKED_PER_STEP:
            fail(f"packed launches per step {d}, expected {PACKED_PER_STEP}")
    llm = [i for i, n in enumerate(opt.names)
           if n.startswith("fusion.language_model.")]
    moved = sum(not torch.equal(snap[i], opt.params[i]) for i in llm)
    same = all(torch.equal(p.detach().cpu(), frozen[n])
               for n, p in model.named_parameters() if n not in trained)
    say(f"[packed] bf16: {moved} of {len(llm)} LLM tensors moved over steps "
        f"2-4; frozen SAM weights bit-identical: {same}")
    if not moved or not same:
        fail("packed: the LLM weights did not move or frozen ones did")
    lat = [t[0] for t in timed]
    say(f"[packed] bf16 flagship sft step (SAM ViT-B + InternLM2-1.8B, one "
        f"packed row of 2560 tokens, two images, remat on): "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms, mean "
        f"{sum(lat) / 3:.1f} ms, {2560 * 3 / sum(lat) * 1e3:.0f} tokens/s; "
        f"peak {peak / 2**30:.3f} GiB (max_memory_allocated), so "
        f"{(peak - weights - moments) / 2**30:.3f} GiB above weights and "
        f"moments")
    del opt, step, snap, frozen, batch
    torch.cuda.empty_cache()

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


# ---------------------------------------------------------------------------
# phase 9: caption generation with the int8 weight-only LLM
# ---------------------------------------------------------------------------

W8A16_KERNEL = ("w8a16_matmul", "ullsam_tpu_torch/csrc/w8a16_matmul.cu",
                "ullsam_tpu/ops/pallas/int8_matmul.py:29")
# B12 launches of one decode step of InternLM2-1.8B, and of one prefill:
# wqkv, wo, w1, w3, w2 in each of 24 layers, and the vocab head
B12_PER_PASS = 5 * 24 + 1


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
    the decode batches 1 and 8 and at the prefill of the caption prompt,
    M = 1152 and 9216: the head's last N tile is ragged there), x in bf16
    and f32: the f32 output within 1e-5 of max|plain| (int8 -> x's type is
    exact, only the summation order differs), and with a bias and the cast
    to x's type (the main path's variant) within one step of that type at
    max|plain| (bf16: 2^(e - 8) for max|plain| in [2^(e-1), 2^e), up to 2^-7
    of it: two f32 sums that differ in their last bits can round to
    neighbouring values; f32: 1e-5 of max|plain|). Decode kernel and library times are device times (``_graph_ms``) with a
    cold L2 (the weight cycles through copies); a prefill launch runs for
    milliseconds, so CUDA events around 3 calls time it. The library
    yardstick is F.linear on the dequantized weight in x's type (2 bytes a
    weight in bf16): no PyTorch call computes W8A16 with f32 scales, and
    the port never calls it."""
    import math

    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.tools.main_path import (W8A16_DECODE_M, w8a16_case,
                                                  w8a16_cases)

    name, source, replaces = W8A16_KERNEL
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "cases": []}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for M, N, K in w8a16_cases():
            (x, q, s), _, flops, nbytes = w8a16_case(dtype, gen, M, N, K)
            bias = torch.randn(N, generator=gen, device="cuda")
            got, ref = Q.w8a16_matmul(x, q, s), Q.w8a16_matmul_plain(x, q, s)
            got_c = Q.w8a16_matmul(x, q, s, bias, out_dtype=dtype)
            ref_c = Q.w8a16_matmul_plain(x, q, s, bias, dtype)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            top = float(ref_c.float().abs().max())
            rel_c = float((got_c.float() - ref_c.float()).abs().max()) / top
            step = (2.0 ** (math.frexp(top)[1] - 8) / top
                    if dtype == torch.bfloat16 else 1e-5)
            ok = (bool(torch.isfinite(got).all()) and rel <= 1e-5
                  and rel_c <= step)
            say(f"[kernels] {name} {dname} M={M} N={N} K={K}: max_abs_err="
                f"{err:.3e} max_rel_err={rel:.3e} (f32 output, relative to "
                f"max|plain|; tol 1e-05), with bias and cast to {dname} "
                f"{rel_c:.3e} (tol {step:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dname} M={M} N={N} K={K} disagrees with its "
                     f"plain version")
            del got, ref, got_c, ref_c
            w_lib = (q.to(dtype) * s[:, None]).to(dtype)
            if M in W8A16_DECODE_M:
                ms = _graph_ms(lambda w: Q.w8a16_matmul(x, w, s), _copies(q))
                lib_ms = _graph_ms(lambda w: F.linear(x, w), _copies(w_lib))
            else:
                ms = cuda_time_ms(lambda: Q.w8a16_matmul(x, q, s), iters=3,
                                  warmup=1)
                lib_ms = cuda_time_ms(lambda: F.linear(x, w_lib), iters=3,
                                      warmup=1)
            plain_ms = cuda_time_ms(lambda: Q.w8a16_matmul_plain(x, q, s),
                                    iters=3, warmup=1)
            del w_lib
            torch.cuda.empty_cache()
            b_ms, b_by = bound_ms(flops, nbytes, dtype)
            say(f"[kernels] {name} {dname} M={M} N={N} K={K}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (F.linear "
                f"on the dequantized {dname} weight) {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB; data-sheet peaks at 700 W, card: "
                f"{card}), {nbytes / ms / 1e6:.1f} GB/s, "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            row["cases"].append({"dtype": dname, "M": M, "N": N, "K": K,
                                 **entry})
            # the row's own numbers: w1, a layer's largest linear, at batch 1
            if (M, N, K) == (1, 8192, 2048):
                if dtype == torch.bfloat16:
                    row.update(entry)
                else:
                    row["float32"] = entry
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
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        toks, lens = chat.caption_ids(
            model, cfg, *inputs, gen=gen,
            step_hook=lambda i, lg: marks.append((time.perf_counter(),
                                                  launch_counts())))
        end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - base
        counts = [before] + [c for _, c in marks]
        diffs = [{k: b[k] - a[k] for k in b if b[k] != a[k]}
                 for a, b in zip(counts, counts[1:])]
        want_pre = dict(encode, **({"w8a16_matmul": B12_PER_PASS} if b12
                                   else {}))
        want_dec = {"w8a16_matmul": B12_PER_PASS} if b12 else {}
        bad = [d for d in diffs[1:] if d != want_dec]
        B, n_tok = toks.shape[0], int(lens.sum())
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
            f"prefill {diffs[0]}, decode step {diffs[1] if steps else {}}")
        if diffs[0] != want_pre or bad:
            fail(f"caption {tag}: launches prefill {diffs[0]} (expected "
                 f"{want_pre}), decode steps off {want_dec}: {bad[:2]}")
        return toks.cpu(), lens.cpu(), pre_ms, dec_ms

    w16 = torch.cuda.memory_allocated()
    run("bf16 warm request", one, False)
    t16, _, _, _ = run("bf16 request", one, False)
    run("bf16 batch-8 request", eight, False)
    lm = model.fusion.language_model
    torch.cuda.synchronize()
    quantize_llm_int8(lm)
    torch.cuda.empty_cache()
    w8 = torch.cuda.memory_allocated()
    say(f"[caption] weights {w16 / 2**30:.3f} GiB in bf16, {w8 / 2**30:.3f} "
        f"GiB with the LLM's linears int8 (memory_allocated)")
    run("int8 warm request", one, True)
    timed = [run(f"int8 request {i}", one, True) for i in (1, 2, 3)]
    run("int8 batch-8 request", eight, True)
    t8 = timed[0][0]
    agree = int((t8 == t16).sum())
    say(f"[caption] int8 vs bf16, batch 1: {agree} of 256 greedy tokens "
        f"agree position by position (printed only)")
    say(f"[caption] int8 batch 1: prefill "
        f"{', '.join(f'{r[2]:.1f}' for r in timed)} ms; decode "
        f"{', '.join(f'{r[3]:.3f}' for r in timed)} ms a step")
    del model, lm
    torch.cuda.empty_cache()


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
    """Phase 10 (a): B1, B2, B3 at head dim 80 (entries ``vit_h`` and
    ``vit_h_float32`` of their rows) and B13, B14, B15 (their own rows at
    ViT-H, entries ``vit_b`` / ``vit_b_float32`` at ViT-B) against their
    plain versions at the path's shapes, bf16 and f32, each timed with its
    plain version, the library yardstick and the bound."""
    import torch
    import torch.nn.functional as F
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    from ullsam_tpu_torch.ops.kernels.window_attention import (_rel_terms,
                                                               _split_heads)
    from ullsam_tpu_torch.tools.main_path import (
        VIT_B, VIT_H, ln_mlp_case, vit_flash_case, vit_flash_packed_case,
        window_attn_case, window_core_case)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    opt_in = {name for name, _, _ in VIT_H_KERNELS}
    for name, source, replaces in VIT_H_KERNELS:
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces}

    def window_lib(qkv, rh, rw, nh):
        """SDPA with the window bias materialized (B3's yardstick)."""
        ws, hd = rh.shape[0], rh.shape[-1]
        q, k, v = (t.to(qkv.dtype) for t in _split_heads(qkv, ws * ws, hd))
        rel_h, rel_w = _rel_terms(q.float(), rh.float(), rw.float(), ws, ws)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2).to(
            qkv.dtype)
        return _sdpa_ms(q, k, v, bias, False)

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
        fwd, _, cflops, cbytes = window_core_case(dtype, gen, nh=16, hd=80)
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
                              lambda: window_lib(*fwd, 16)))
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
                          lambda t=twophase, nh=width["nh"]:
                          window_lib(*t, nh)))
        for name, tag, kernel, plain, args, kw, flops, nbytes, lib in cases:
            got, ref = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = _errs(f"{name} ({tag})", dname, got, ref, tol[dtype])
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
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
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
        del cases, fwd, twophase
        torch.cuda.empty_cache()
    return rows


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

    def run(generator, image, tag, want):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, data = generator.generate_dense(image)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
        n = len(data["iou_preds"])
        if (masks.dtype != torch.bool or tuple(masks.shape) != (n, 1024, 1024)
                or n != 256 or not np.isfinite(data["iou_preds"]).all()
                or not np.isfinite(data["stability"]).all()):
            fail(f"ViT-H AMG {tag}: masks {tuple(masks.shape)} {masks.dtype}")
        say(f"[vit_h] {tag}: {n} masks, latency {ms:.1f} ms (host clock, "
            f"ends in synchronize), launches {d}")
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
        f"{(peak - weights) / 2**30:.3f} GiB for the sweep")

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
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                emb = S.encode_image(model16.image_encoder, x)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                d = {k: v - before[k] for k, v in launch_counts().items()
                     if v != before[k]}
                if d != want:
                    fail(f"ViT-H encode, route {route}: launches {d}, "
                         f"expected {want}")
        if tuple(emb.shape) != (1, 64, 64, 256) or not bool(
                torch.isfinite(emb).all()):
            fail(f"ViT-H encode, route {route}: {tuple(emb.shape)}")
        embs[route] = emb.float()
        say(f"[vit_h] bf16 encode, route {route}: "
            f"{', '.join(f'{t:.2f}' for t in lat)} ms (host clock, ends in "
            f"synchronize; median {sorted(lat)[2]:.2f}), launches {d}")

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
    run(AutomaticMaskGenerator(cfg, model32, **sweep), images[1],
        "f32 image 1 (TF32 off)", default)
    peak = torch.cuda.max_memory_allocated()
    say(f"[vit_h] f32: weights {weights / 2**30:.3f} GiB resident, peak "
        f"{peak / 2**30:.3f} GiB, so {(peak - weights) / 2**30:.3f} GiB for "
        f"the sweep")
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
    rows.update(check_train_kernels(smi))
    rows.update(check_llm_kernels(smi))
    rows.update(check_w8a16_kernel(smi))
    rows = check_vit_h_kernels(smi, rows)
    small_reference_check()
    amg_small_reference_check()
    train_small_reference_check()
    packed_small_reference_check()
    caption_small_reference_check()
    vit_h_small_reference_check()
    by_path = {}
    for path, drive in (("interactive", main_path), ("amg", amg_main_path),
                        ("train", train_main_path),
                        ("packed", packed_main_path),
                        ("caption", caption_main_path),
                        ("vit_h", vit_h_main_path)):
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
