"""A/B timing of the mask decoder's kernels B4, B5, B6 and B7 built from
several source trees, in one process on one card, so that versions compare
within one call (two calls may land on two cards).

    python -m ullsam_tpu_torch.tools.ab_decoder [--dtypes=float32,bfloat16] \
        [--amg=vit_b,vit_h] NAME=CSRC_DIR [...]

Each CSRC_DIR holds ``decoder_twt.cu``, ``decoder_image.cu``,
``decoder_upscale.cu`` and the headers they include: a checkout's
``ullsam_tpu_torch/csrc``, or another commit's unpacked by ``git archive``
into a directory that git ignores. Each version is built with
``build.NVCC_FLAGS`` under ``csrc/_build/ab/<NAME>/`` (its ptxas registers
and spills printed) and driven through this tree's
``ops/kernels/decoder.py`` with its C functions taken from that version's
libraries; a version whose ``decoder_image`` has no
``decoder_image_stage_f32`` entry takes the route it was written for:
float32 on the chain of primitive kernels. At the AMG chunk of SAM ViT-B
(256 prompts x 64x64, T = 7, M = 3; ``tools/main_path.py``) each wrapper
is checked against its plain version (float32 1e-4, bf16 2e-2 of
max|plain|; statistics exactly against the plain statistics of the
version's own logits), each version's outputs bitwise against the first
version's, in float32 B4's and B5's outputs against a float64 evaluation
of the plain version beside the plain float32 version's own error; then
timed by CUDA events (5 launches after 1) in the order given and again in
reverse (a, b, ..., b, a). With ``--amg`` also whole float32 AMG images of
each named SAM (random weights from seed 0, 1024x1024 images, 32x32 points
in chunks of 256, thresholds and NMS off) under each version in the same
order, 1 warm and 3 timed images a turn (host clock ending in a
synchronize), with the sweep's peak device memory above the weights; the
encoder's kernels are this tree's in every version. TF32 is off in
PyTorch. Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels import decoder as D
from ullsam_tpu_torch.tools import main_path as MP

_SOURCES = ("decoder_twt", "decoder_image", "decoder_upscale")
_NAMES = (("B4", "decode_masks"), ("B5", "two_way_transformer"),
          ("B6", "upscale_hypernet_stats"), ("B7", "upscale_hypernet"))
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def build_version(name: str, csrc: str) -> dict:
    """{source: CDLL} of the decoder's sources in ``csrc``, built in
    parallel into csrc/_build/ab/<name>/."""
    out = os.path.join(build.BUILD_DIR, "ab", name)
    os.makedirs(out, exist_ok=True)
    procs = {src: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc, "-o",
         os.path.join(out, src + ".so"), os.path.join(csrc, src + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in _SOURCES}
    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name} {src}: registers {sorted(set(regs))}, spill "
              f"stores {sorted(set(spills))}")
        libs[src] = ctypes.CDLL(os.path.join(out, src + ".so"))
    return libs


@contextlib.contextmanager
def version(libs: dict):
    """decoder.py's C functions from ``libs``; float32 on the chain where
    the version has no fused float32 kernels. Yields whether it has."""
    f32 = hasattr(libs["decoder_image"], "decoder_image_stage_f32")
    fns = {}

    def fn(name):
        if name not in fns:
            lib, argtypes = D._SIGNATURES[name]
            f = getattr(libs[lib], name)
            f.argtypes = argtypes
            f.restype = (ctypes.c_longlong if name == "decoder_t2i_scratch"
                         else ctypes.c_int)
            fns[name] = f
        return fns[name]

    saved = D._fn, D.fused_twt, D.fused_upscale
    D._fn = fn
    if not f32:
        D.fused_twt = lambda dt, *a: dt == torch.bfloat16 and saved[1](dt, *a)
        D.fused_upscale = (lambda dt, *a: dt == torch.bfloat16
                           and saved[2](dt, *a))
    try:
        yield f32
    finally:
        D._fn, D.fused_twt, D.fused_upscale = saved


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _ms(fn, iters: int = 5, warmup: int = 1) -> float:
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


def _as_f64(args):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()
                    if not k.endswith(("_hi", "_lo"))}
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.double()
        return t
    return tuple(conv(a) for a in args)


def check(label: str, dtype, name: str, args, kw, versions: dict) -> None:
    """Each version's outputs against plain, against the first version's
    (bitwise) and, in float32 for B4 / B5, against float64."""
    plain = getattr(D, name + "_plain")
    ref_f, _, _ = MP.decoder_outputs(name, plain(*args, **kw))
    ref64 = None
    if dtype == torch.float32 and name in ("decode_masks",
                                           "two_way_transformer"):
        ref64 = MP.decoder_outputs(name, plain(*_as_f64(args), **kw))[0]
    first = None
    for vname, libs in versions.items():
        with version(libs) as f32:
            got = getattr(D, name)(*args, **kw)
            torch.cuda.synchronize()
        g_f, g_i, logits = MP.decoder_outputs(name, got)
        rel = max(float((a.float() - b.float()).abs().max()
                        / b.float().abs().max()) for a, b in zip(g_f, ref_f))
        exact = g_i is None or all(torch.equal(a, b) for a, b in zip(
            g_i, D.upscale_stats_plain(logits, kw["thr"], kw["off"])))
        same = "first" if first is None else (
            "bitwise" if all(torch.equal(a, b) for a, b in zip(
                _tensors(got), first)) else "differs")
        if first is None:
            first = _tensors(got)
        note = ""
        if ref64 is not None:
            ek = max(float((a.double() - r).abs().max() / r.abs().max())
                     for a, r in zip(g_f, ref64))
            ep = max(float((b.double() - r).abs().max() / r.abs().max())
                     for b, r in zip(ref_f, ref64))
            note = (f", against float64 {ek:.3e} (plain f32 {ep:.3e}, "
                    f"{ek / ep:.2f}x)")
        ok = rel <= _TOL[dtype] and exact
        print(f"[check] {label} {vname} ({'fused f32' if f32 else 'chain'}"
              f" in f32): max_rel_err={rel:.3e}, statistics "
              f"{'n/a' if g_i is None else 'exact' if exact else 'DIFFER'}"
              f", against the first version {same}{note} "
              f"{'ok' if ok else 'FAIL'}")
        del got, g_f, g_i, logits
    del first, ref_f, ref64
    torch.cuda.empty_cache()


def amg_images(variant: str, versions: dict, order: list) -> None:
    """float32 AMG images of SAM ``variant`` under each version in
    ``order``: 1 warm + 3 timed a turn, the sweep's peak above the
    weights."""
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
    from ullsam_tpu_torch.models.sam.registry import build_sam
    cfg, model = build_sam(variant, seed=0, device="cuda")
    images = MP.amg_inputs(np.random.default_rng(0), 4)
    gen = AutomaticMaskGenerator(
        cfg, model, points_per_side=32, points_per_batch=256,
        pred_iou_thresh=0.0, stability_score_thresh=0.0, box_nms_thresh=1.0,
        max_masks=256)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    for vname in order:
        with version(versions[vname]):
            gen.generate_dense(images[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for image in images[1:]:
                t0 = time.perf_counter()
                masks, _ = gen.generate_dense(image)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = (torch.cuda.max_memory_allocated() - weights) / 2**30
            del masks
        torch.cuda.empty_cache()
        print(f"[amg] {variant} float32 {vname}: "
              f"{', '.join(f'{t:.1f}' for t in ms)} ms an image, sweep peak "
              f"{peak:.3f} GiB above the weights")
    del gen, model
    torch.cuda.empty_cache()


def main() -> None:
    dtypes = (torch.float32, torch.bfloat16)
    specs, amg = [], []
    for a in sys.argv[1:]:
        if a.startswith("--dtypes="):
            dtypes = tuple(getattr(torch, d) for d in a[9:].split(","))
        elif a.startswith("--amg="):
            amg = a[6:].split(",")
        else:
            specs.append(a.split("=", 1))
    if not specs or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    versions = {name: build_version(name, csrc) for name, csrc in specs}
    order = list(versions) + list(reversed(versions))
    for dtype in dtypes:
        dname = str(dtype).replace("torch.", "")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        with version(next(iter(versions.values()))):
            cases = MP.decoder_cases(dtype, gen, **MP.AMG_CHUNK)
        for label, name in _NAMES:
            args, kw, flops, _ = cases[name]
            check(f"{label} {dname}", dtype, name, args, kw, versions)
            times = []
            for vname in order:
                with version(versions[vname]):
                    times.append((vname, _ms(
                        lambda: getattr(D, name)(*args, **kw))))
                torch.cuda.empty_cache()
            print(f"[ab] {label} {dname} ms: " + ", ".join(
                f"{v} {t:.4f}" for v, t in times)
                + f" ({flops / 1e9:.1f} GFLOP)")
        del cases
        torch.cuda.empty_cache()
    for variant in amg:
        amg_images(variant, versions, order)


if __name__ == "__main__":
    main()
