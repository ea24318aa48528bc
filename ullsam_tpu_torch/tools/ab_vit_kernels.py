"""A/B timing of the ViT kernels B1, B2, B3, B8 (float32), B9 (both
dtypes), B13, B14, B15 and of B12 (the int8 LLM linears) built from
several source trees, in one process on one card, so that versions
compare within one call (two calls may land on two cards). B1, B2, B3,
B13, B14, B15 and the products of B1 / B13 also in float32.

    python -m ullsam_tpu_torch.tools.ab_vit_kernels [--only=B2,B12,...] \
        NAME=CSRC_DIR [...]

Each CSRC_DIR holds ``window_attn.cu``, ``window_attn_twophase.cu``,
``window_attn_bwd.cu``, ``ln_mlp.cu``, ``vit_flash_attn.cu``,
``vit_flash_bwd.cu``, ``w8a16_matmul.cu`` and the headers they include: a
checkout's ``ullsam_tpu_torch/csrc``, or another commit's unpacked by
``git archive`` into a directory that git ignores. Each version is built
with ``build.NVCC_FLAGS`` under ``csrc/_build/ab/`` (its ptxas registers,
spills and C7515 advisories printed; with ``--only``, just the sources
those cases need), checked against the plain versions
at the main path's shapes (``tools/main_path.py``; bf16 unless stated: B1
and B3 / B15 at ViT-B and ViT-H, B13 at ViT-H with T = 4900, B2, B14 and
B9 at both widths' global blocks, B2, B14 and B9 in float32 too (a version
that refuses a case, as B9 before head dim 80, is left out of it; one
without the float32 scratch argument is called without it; B2 and B14's
outputs are o and lse), B8 in float32 at both
widths' windows, B12 at every shape of ``main_path.w8a16_cases`` but the
head's prefill at 1152 and 9216 rows (decode at 1-16 rows, the serving
engine's 128- and 256-row segments, the caption prompt's 1152 and 9216,
the tp 2 ranks' linears), bf16 out as the LLM's linears call it, and
with f32 x at every shape (f32 out, held also against float64); a
version whose B12 entry takes a workspace
(``w8a16_workspace``) gets it as its own plan asks, an earlier one is
called as it was), then timed by CUDA events (20 launches after 3; B12 at
decode and the segments from a CUDA graph of its launches, decode with
the weight cold in L2 and ``F.linear`` on copies of the dequantized
weight beside it) in the order given and again in reverse (a,
b, ..., b, a), beside the library yardsticks (TF32 off): SDPA with the
bias materialized for B2, B3, B14, B15 (for B9 its backward alone on a
retained graph), the chain of four library calls for B13, F.linear on the
dequantized weight for B12, and, where the version has the entry
``gemm_bf16_forward``, each bf16 product of B1 and B13 (proj and fc2 with
their residual) beside ``F.linear`` (without it). In float32 (labels with
"f32") B1 and B3 / B15 at both widths, B13 at ViT-H and, where a version
has ``gemm_f32_forward``, each f32 product of B1 and B13; each such
version's output is also held against a float64 evaluation of the plain
version beside the plain float32 version's own error. Each version's
output is compared bitwise with the first version's. ``--only`` keeps the
cases whose label starts with one of the given prefixes (B1, B2, B3, B8,
B9, B12, B13, B14, B15, GEMM, or a longer one such as "B12 f32 M8 ").
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels import flash_attention as FA
from ullsam_tpu_torch.ops.kernels import gemm as G
from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
from ullsam_tpu_torch.ops.kernels import vit_block as VB
from ullsam_tpu_torch.ops.kernels import window_attention as WA
from ullsam_tpu_torch.tools import main_path as MP

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
_SOURCES = ("window_attn", "window_attn_twophase", "window_attn_bwd",
            "ln_mlp", "vit_flash_attn", "vit_flash_bwd", "w8a16_matmul")
_ENTRIES = {
    "b2": ("vit_flash_attn", "vit_flash_attn_forward",
           [_I] + [_P] * 8 + [_I] * 5 + [_F, _P]),
    "b14": ("vit_flash_attn", "vit_flash_attn_packed_forward",
            [_I] + [_P] * 6 + [_I] * 6 + [_F, _P]),
    "b12": ("w8a16_matmul", "w8a16_matmul", [_I] + [_P] * 5 + [_I] * 4
            + [_P]),   # with split-K: _b12_entry's signature
    "b3": ("window_attn", "window_attn_core_forward",
           [_I] + [_P] * 4 + [_I] * 7 + [_P]),
    "b15": ("window_attn_twophase", "window_attn_twophase_forward",
            [_I] + [_P] * 4 + [_I] * 7 + [_P]),
    "b1": ("window_attn", "window_attn_forward",
           [_I] + [_P] * 13 + [_I] * 7 + [_F] + [_I] * 5 + [_P]),
    "b13": ("ln_mlp", "ln_mlp_forward", [_I] + [_P] * 10 + [_I] * 3
            + [_F, _P]),
    "gemm": ("ln_mlp", "gemm_bf16_forward", [_P] * 5 + [_I] * 4 + [_P]),
    "gemm_f32": ("ln_mlp", "gemm_f32_forward", [_P] * 5 + [_I] * 4 + [_P]),
    "b9": ("vit_flash_bwd", "vit_flash_attn_backward",
           [_I] + [_P] * 14 + [_I] * 5 + [_F, _P]),
    "b8": ("window_attn_bwd", "window_attn_bwd",
           [_I] + [_P] * 10 + [_I] * 7 + [_P]),
}


# the sources each case label's kernel needs
_LABEL_SOURCES = {"B1": ("window_attn",), "B2": ("vit_flash_attn",),
                  "B3": ("window_attn",), "B8": ("window_attn_bwd",),
                  "B9": ("vit_flash_bwd",), "B12": ("w8a16_matmul",),
                  "B13": ("ln_mlp",), "B14": ("vit_flash_attn",),
                  "B15": ("window_attn_twophase",), "GEMM": ("ln_mlp",)}


def build_version(name: str, csrc: str, sources=_SOURCES) -> dict:
    """{entry: the bound C function} of ``sources`` in ``csrc``, built in
    parallel into csrc/_build/ab/<name>/; entries a version lacks are left
    out."""
    out = os.path.join(build.BUILD_DIR, "ab", name)
    os.makedirs(out, exist_ok=True)
    procs = {src: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc, "-o",
         os.path.join(out, src + ".so"), os.path.join(csrc, src + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources}
    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name} {src}: registers {sorted(set(regs))}, spill "
              f"stores {sorted(set(spills))}, {log.count('C7515')} C7515 "
              f"advisories (wgmma serialized)")
        for line in log.splitlines():
            if "C7515" in line:
                print(f"[build] {name} {src}: {line.strip()[:400]}")
        libs[src] = ctypes.CDLL(os.path.join(out, src + ".so"))
    fns = {}
    for key, (src, fn_name, argtypes) in _ENTRIES.items():
        fn = getattr(libs[src], fn_name, None) if src in libs else None
        if fn is None:
            continue
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[key] = fn
        if key == "b9" and not hasattr(libs[src],
                                       "vit_flash_bwd_scratch_bytes"):
            # before the float32 split pre-pass: no scratch argument
            fn.argtypes = argtypes[:14] + argtypes[15:]
            fns[key] = lambda *a, f=fn: f(*a[:14], *a[15:])
        if key in ("b2", "b14") and not hasattr(
                libs[src], "vit_flash_fwd_scratch_bytes"):
            # before the float32 split pre-pass: no scratch argument
            cut = 8 if key == "b2" else 6
            fn.argtypes = argtypes[:cut] + argtypes[cut + 1:]
            fns[key] = lambda *a, f=fn, c=cut: f(*a[:c], *a[c + 1:])
        if key == "b12" and hasattr(libs[src], "w8a16_workspace"):
            fns[key] = _b12_entry(fn, libs[src])
    return fns


def _b12_entry(fn, lib):
    """B12's entry of a version with split-K (it plans splits and takes a
    workspace and tile counters) as the earlier signature: each shape's f32
    partials and zeroed counters allocated once, as the version's own
    ``w8a16_workspace`` asks."""
    fn.argtypes = ([_I] + [_P] * 5 + [_I] * 4
                   + [_P, ctypes.c_longlong, _P, _I, _P])
    size = lib.w8a16_workspace
    size.argtypes, size.restype = [_I] * 5, ctypes.c_longlong
    bufs = {}

    def call(dtype, x, q, s, bias, out, out_f32, M, N, K, stream):
        key = (dtype, M, N, K)
        if key not in bufs:
            n_ws = max(size(dtype, M, N, K, 0), 0)
            bufs[key] = (torch.empty(max(n_ws, 1), device="cuda"), n_ws,
                         torch.zeros(1 << 16, dtype=torch.int32,
                                     device="cuda"))
        ws, n_ws, cnt = bufs[key]
        return fn(dtype, x, q, s, bias, out, out_f32, M, N, K,
                  ws.data_ptr(), n_ws, cnt.data_ptr(), cnt.numel(), stream)
    return call


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def _rel(a, b) -> float:
    """max|a - b| / max|b|, the worst over the outputs of a tuple."""
    if isinstance(a, tuple):
        return max(_rel(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _f64(plain, args, kw=None):
    """A thunk: ``plain`` on ``args`` (their float tensors in float64)."""
    return lambda: plain(*(a.double() if isinstance(a, torch.Tensor)
                           and a.is_floating_point() else a for a in args),
                         **(kw or {}))


def f32_cases(gen, stream):
    """The float32 cases of B3 / B15, B1 (both widths), B13 and the GEMM
    (ViT-H; its products at ViT-B too), with float64 references."""
    out = []
    f32 = torch.float32
    for tag, w in (("vit_b", MP.VIT_B), ("vit_h", MP.VIT_H)):
        nh, hd = w["nh"], w["C"] // w["nh"]
        (qkv, rh, rw), _, fl, _ = MP.window_core_case(f32, gen, nh=nh, hd=hd)
        M, C = qkv.shape[0], qkv.shape[1] // 3
        o = torch.empty((M, C), device="cuda")
        q, k, v = WA._split_heads(qkv, 196, hd)
        rel_h, rel_w = WA._rel_terms(q, rh, rw, 14, 14)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2)
        ref = WA.window_attn_core_plain(qkv, rh, rw)
        for key in ("b3", "b15"):
            out.append((f"{key.upper()} f32 {tag}", key,
                        lambda f, qkv=qkv, rh=rh, rw=rw, o=o, M=M, C=C,
                        nh=nh, hd=hd: f(0, qkv.data_ptr(), rh.data_ptr(),
                                        rw.data_ptr(), o.data_ptr(), M // 196,
                                        196, C, nh, hd, 14, 14, stream),
                        o, ref, fl["fwd"],
                        lambda q=q, k=k, v=v, b=bias:
                        F.scaled_dot_product_attention(q, k, v, attn_mask=b),
                        _f64(WA.window_attn_core_plain, (qkv, rh, rw))))
        args, kw, fl1, _ = MP.window_attn_case(f32, gen, **w)
        x = args[0]
        Bw, n, C = x.shape
        bufs = [torch.empty((Bw * n, c), device="cuda") for c in
                (C, 3 * C, C)]
        o1 = torch.empty_like(x)
        out.append((f"B1 f32 {tag}", "b1",
                    lambda f, a=args, kw=kw, bufs=bufs, o1=o1, C=C, nh=nh,
                    hd=hd, Bw=Bw, n=n: f(
                        0, *(t.data_ptr() for t in a),
                        *(t.data_ptr() for t in bufs), o1.data_ptr(), Bw, n,
                        C, nh, hd, 14, 14, kw["eps"], kw["nwx"], kw["nwy"],
                        kw["Hv"], kw["Wv"], int(kw["masked"]), stream),
                    o1, VB.window_attn_plain(*args, **kw), fl1, None,
                    _f64(VB.window_attn_plain, args, kw)))
    args, kw, fl, _ = MP.ln_mlp_case(f32, gen, T=4900, **MP.VIT_H)
    x, lw, lb, w1, b1, w2, b2 = args
    T, C = x.shape
    Fd = w1.shape[0]
    y, h = torch.empty_like(x), torch.empty((T, Fd), device="cuda")
    o13 = torch.empty_like(x)
    out.append(("B13 f32 vit_h T4900", "b13",
                lambda f: f(0, *(t.data_ptr() for t in args), y.data_ptr(),
                            h.data_ptr(), o13.data_ptr(), T, C, Fd,
                            kw["eps"], stream),
                o13, VB.ln_mlp_plain(*args, **kw), fl,
                lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(
                    x, (C,), lw, lb, kw["eps"]), w1, b1),
                    approximate="tanh"), w2, b2),
                _f64(VB.ln_mlp_plain, args, kw)))
    for tag, N, K, act, with_res in (
            ("vit_h qkv", 3840, 1280, 0, False),
            ("vit_h proj", 1280, 1280, 0, True),
            ("vit_h fc1", 5120, 1280, 2, False),
            ("vit_h fc2", 1280, 5120, 0, True),
            ("vit_b qkv", 2304, 768, 0, False),
            ("vit_b proj", 768, 768, 0, True)):
        a = torch.randn(4900, K, generator=gen, device="cuda")
        wt = torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        res = (torch.randn(4900, N, generator=gen, device="cuda")
               if with_res else None)
        go = torch.empty((4900, N), device="cuda")
        actn = "gelu_tanh" if act else "none"
        out.append((f"GEMM f32 {tag} M4900 N{N} K{K}"
                    f"{' +residual' if with_res else ''}", "gemm_f32",
                    lambda f, a=a, wt=wt, b=b, go=go, N=N, K=K, act=act,
                    res=res: f(a.data_ptr(), wt.data_ptr(), b.data_ptr(),
                               None if res is None else res.data_ptr(),
                               go.data_ptr(), 4900, N, K, act, stream),
                    go, G.gemm_plain(a, wt, b, res, actn), 2 * 4900 * N * K,
                    lambda a=a, wt=wt, b=b: F.linear(a, wt, b),
                    _f64(G.gemm_plain, (a, wt, b, res, actn))))
    return out


def cases(gen):
    """(label, entry, the C call, its output, the plain result, flops,
    library call or None, float64 reference thunk or None) at the main
    path's bf16 shapes, then the float32 cases (``f32_cases``)."""
    out = []
    stream = torch.cuda.current_stream().cuda_stream
    for tag, w in (("vit_b", MP.VIT_B), ("vit_h", MP.VIT_H)):
        nh, hd = w["nh"], w["C"] // w["nh"]
        (qkv, rh, rw), _, fl, _ = MP.window_core_case(torch.bfloat16, gen,
                                                      nh=nh, hd=hd)
        M, C = qkv.shape[0], qkv.shape[1] // 3
        o = torch.empty((M, C), device="cuda", dtype=torch.bfloat16)
        q, k, v = (t.bfloat16() for t in WA._split_heads(qkv, 196, hd))
        rel_h, rel_w = WA._rel_terms(q.float(), rh.float(), rw.float(), 14,
                                     14)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2).to(
            torch.bfloat16)
        ref = WA.window_attn_core_plain(qkv, rh, rw)
        for key in ("b3", "b15"):
            out.append((f"{key.upper()} {tag}", key,
                        lambda f, qkv=qkv, rh=rh, rw=rw, o=o, M=M, C=C,
                        nh=nh, hd=hd: f(1, qkv.data_ptr(), rh.data_ptr(),
                                        rw.data_ptr(), o.data_ptr(), M // 196,
                                        196, C, nh, hd, 14, 14, stream),
                        o, ref, fl["fwd"],
                        lambda q=q, k=k, v=v, b=bias:
                        F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=b)))
        args, kw, fl1, _ = MP.window_attn_case(torch.bfloat16, gen, **w)
        x = args[0]
        Bw, n, C = x.shape
        bufs = [torch.empty((Bw * n, c), device="cuda", dtype=x.dtype)
                for c in (C, 3 * C, C)]
        o1 = torch.empty_like(x)
        out.append((f"B1 {tag}", "b1",
                    lambda f, a=args, kw=kw, bufs=bufs, o1=o1, C=C, nh=nh,
                    hd=hd, Bw=Bw, n=n: f(
                        1, *(t.data_ptr() for t in a),
                        *(t.data_ptr() for t in bufs), o1.data_ptr(), Bw, n,
                        C, nh, hd, 14, 14, kw["eps"], kw["nwx"], kw["nwy"],
                        kw["Hv"], kw["Wv"], int(kw["masked"]), stream),
                    o1, VB.window_attn_plain(*args, **kw), fl1, None))
        for N, K, res in ((3 * C, C, None), (C, C, x.reshape(-1, C))):
            a = torch.randn(4900, K, generator=gen, device="cuda").bfloat16()
            wt = (torch.randn(N, K, generator=gen, device="cuda")
                  * K ** -0.5).bfloat16()
            b = torch.randn(N, generator=gen, device="cuda").bfloat16()
            go = torch.empty((4900, N), device="cuda", dtype=torch.bfloat16)
            out.append((f"GEMM {tag} M4900 N{N} K{K}"
                        f"{'' if res is None else ' +residual'}", "gemm",
                        lambda f, a=a, wt=wt, b=b, go=go, N=N, K=K, res=res:
                        f(a.data_ptr(), wt.data_ptr(), b.data_ptr(),
                          None if res is None else res.data_ptr(),
                          go.data_ptr(), 4900, N, K, 0, stream),
                        go, G.gemm_plain(a, wt, b, res),
                        2 * 4900 * N * K,
                        lambda a=a, wt=wt, b=b: F.linear(a, wt, b)))
    for (tag, w), dt in itertools.product(
            (("vit_b", MP.VIT_B), ("vit_h", MP.VIT_H)),
            (torch.bfloat16, torch.float32)):
        f32 = dt == torch.float32
        lab = "f32 " if f32 else ""
        args, _, fl, _ = MP.vit_flash_case(dt, gen, **w)
        q, k, v, rh, rw = args
        BH, N, D = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((BH, N), device="cuda", dtype=torch.float32)
        scratch = (torch.empty(FA.fwd_f32_scratch_floats(BH, N, D),
                               device="cuda") if f32 else None)
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(BH, N, N)
        out.append((f"B2 {lab}{tag}", "b2",
                    lambda f, a=args, o=o, lse=lse, s=scratch, f32=f32: f(
                        0 if f32 else 1, *(t.data_ptr() for t in a),
                        o.data_ptr(), lse.data_ptr(),
                        None if s is None else s.data_ptr(), a[0].shape[0],
                        a[0].shape[1], a[0].shape[2], 64, 64,
                        FA.q_scale(a[0].shape[2], a[0].dtype), stream),
                    (o, lse), FA.vit_flash_attn_plain(*args), fl,
                    lambda q=q, k=k, v=v, b=bias:
                    F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                   attn_mask=b[None]),
                    _f64(FA.vit_flash_attn_plain, args) if f32 else None))
        args2, kw2, fl2, _ = MP.vit_flash_packed_case(dt, gen, **w)
        nh = kw2["nh"]
        C = args2[0].shape[-1] // 3
        o2 = torch.empty((1, N, C), device="cuda", dtype=dt)
        lse2 = torch.empty((nh, N), device="cuda", dtype=torch.float32)
        out.append((f"B14 {lab}{tag}", "b14",
                    lambda f, a=args2, o=o2, lse=lse2, s=scratch, nh=nh,
                    N=N, D=C // nh, f32=f32: f(
                        0 if f32 else 1, *(t.data_ptr() for t in a),
                        o.data_ptr(), lse.data_ptr(),
                        None if s is None else s.data_ptr(), 1, nh, N, D,
                        64, 64, FA.q_scale(D, a[0].dtype), stream),
                    (o2, lse2), FA.vit_flash_attn_packed_plain(*args2, nh),
                    fl2, lambda q=q, k=k, v=v, b=bias:
                    F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                   attn_mask=b[None]),
                    _f64(FA.vit_flash_attn_packed_plain, args2, kw2)
                    if f32 else None))
        del bias
    for (tag, w), dt in itertools.product(
            (("vit_b", MP.FLASH_BWD), ("vit_h", MP.FLASH_BWD_VIT_H)),
            (torch.bfloat16, torch.float32)):
        args, fl, _ = MP.vit_flash_bwd_case(dt, gen, **w)
        q, k, v, rh, rw = args[:5]
        BH, N, D = q.shape
        outs = tuple(torch.empty_like(q) for _ in range(3)) + tuple(
            torch.empty((BH, N, r.shape[-1]), device="cuda",
                        dtype=torch.float32) for r in (rh, rw))
        f32 = dt == torch.float32
        scratch = (torch.empty(FA.bwd_f32_scratch_floats(BH, N, D),
                               device="cuda") if f32 else None)
        bias = (rh.float()[..., :, None] + rw.float()[..., None, :]
                ).reshape(1, BH, N, N).to(dt).requires_grad_()
        ins = [t[None].detach().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*ins, attn_mask=bias)
        g_lib = torch.randn_like(o_lib)
        out.append((f"B9 {'f32 ' if f32 else ''}{tag}", "b9",
                    lambda f, a=args, o=outs, BH=BH, N=N, D=D, f32=f32,
                    s=scratch: f(
                        0 if f32 else 1, *(t.data_ptr() for t in a),
                        *(t.data_ptr() for t in o),
                        None if s is None else s.data_ptr(), BH, N, D, 64,
                        64, D ** -0.5, stream),
                    outs, FA.vit_flash_attn_bwd_plain(*args), fl,
                    lambda o=o_lib, g=g_lib, i=ins + [bias]:
                    torch.autograd.grad(o, i, g, retain_graph=True)))
    for tag, w in (("vit_b", MP.WINDOW_CORE), ("vit_h", MP.WINDOW_CORE_VIT_H)):
        _, (qkv, rh, rw, do), fl, _ = MP.window_core_case(torch.float32, gen,
                                                          **w)
        ws, hd = rh.shape[0], rh.shape[-1]
        Bw, n, C = qkv.shape[0] // (ws * ws), ws * ws, do.shape[1]
        nh = C // hd
        outs = (torch.empty_like(qkv), torch.empty_like(rh),
                torch.empty_like(rw))
        drel = torch.empty((Bw, nh, n, 2 * ws), device="cuda")
        part = torch.empty((Bw * nh, 2 * ws * ws * hd), device="cuda")
        out.append((f"B8 f32 {tag}", "b8",
                    lambda f, a=(qkv, rh, rw, do), o=outs, drel=drel,
                    part=part, Bw=Bw, n=n, C=C, nh=nh, hd=hd, ws=ws: f(
                        0, *(t.data_ptr() for t in a),
                        *(t.data_ptr() for t in o), drel.data_ptr(),
                        part.data_ptr(), None, Bw, n, C, nh, hd, ws, ws,
                        stream),
                    outs, WA.window_attn_core_bwd_plain(qkv, rh, rw, do),
                    fl["bwd"], None))
    for M in MP.W8A16_PREFILL_M[2:]:
        for N, K in MP.W8A16_LINEARS[:4]:
            (x, q8, sc), _, fl, _ = MP.w8a16_case(torch.bfloat16, gen, M, N,
                                                 K)
            w_lib = (q8.to(torch.bfloat16) * sc[:, None]).to(torch.bfloat16)
            # the bf16 wgmma GEMM of B1 / B13 on the dequantized weight:
            # B12's kernel without the int8 operand
            go = torch.empty((M, N), device="cuda", dtype=torch.bfloat16)
            out.append((f"GEMM llm M{M} N{N} K{K}", "gemm",
                        lambda f, x=x, w=w_lib, go=go, M=M, N=N, K=K:
                        f(x.data_ptr(), w.data_ptr(), None, None,
                          go.data_ptr(), M, N, K, 0, stream),
                        go, G.gemm_plain(x, w_lib), 2 * M * N * K,
                        lambda x=x, w=w_lib: F.linear(x, w)))
    args, kw, fl, _ = MP.ln_mlp_case(torch.bfloat16, gen, T=4900, **MP.VIT_H)
    x, lw, lb, w1, b1, w2, b2 = args
    T, C = x.shape
    Fd = w1.shape[0]
    y = torch.empty_like(x)
    h = torch.empty((T, Fd), device="cuda", dtype=x.dtype)
    o13 = torch.empty_like(x)
    out.append(("B13 vit_h T4900", "b13",
                lambda f: f(1, *(t.data_ptr() for t in args), y.data_ptr(),
                            h.data_ptr(), o13.data_ptr(), T, C, Fd,
                            kw["eps"], stream),
                o13, VB.ln_mlp_plain(*args, **kw), fl,
                lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(
                    x, (C,), lw, lb, kw["eps"]), w1, b1),
                    approximate="tanh"), w2, b2)))
    for N, K, act, res in ((Fd, C, 2, None), (C, Fd, 0, x)):
        a = torch.randn(T, K, generator=gen, device="cuda").bfloat16()
        wt = (torch.randn(N, K, generator=gen, device="cuda")
              * K ** -0.5).bfloat16()
        b = torch.randn(N, generator=gen, device="cuda").bfloat16()
        go = torch.empty((T, N), device="cuda", dtype=torch.bfloat16)
        out.append((f"GEMM vit_h M{T} N{N} K{K}", "gemm",
                    lambda f, a=a, wt=wt, b=b, go=go, N=N, K=K, act=act,
                    res=res: f(a.data_ptr(), wt.data_ptr(), b.data_ptr(),
                               None if res is None else res.data_ptr(),
                               go.data_ptr(), T, N, K, act, stream),
                    go, G.gemm_plain(
                        a, wt, b, res, "gelu_tanh" if act else "none"),
                    2 * T * N * K, lambda a=a, wt=wt, b=b: F.linear(a, wt, b)))
    return ([c + (None,) * (9 - len(c)) for c in out] + b12_cases(gen)
            + [c + (None,) * (9 - len(c)) for c in f32_cases(gen, stream)])


def _copies(t, min_bytes: int = 128 << 20) -> list:
    """``t`` and clones of it, together at least ``min_bytes``: a launch
    that cycles through them finds its weight outside the 50 MB L2, as each
    decode step does."""
    n = max(1, -(-min_bytes // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def graph_ms(call, weights: list, reps: int = 3) -> float:
    """Device time of one ``call(w)``, w cycling through ``weights``: the
    launches captured in a CUDA graph and replayed (a decode-size launch
    takes the host longer to issue than the card to run)."""
    n = max(20, 2 * len(weights))
    for w in weights[:2]:
        call(w)
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


def b12_cases(gen):
    """B12 in bf16 (bf16 out, as the LLM's linears call it) at every shape
    of ``main_path.w8a16_cases`` but the head's prefill at 1152 and 9216
    rows (f32 x at every one): decode (M <= 16)
    and the serving engine's segments (128, 256) timed from a CUDA graph,
    decode with the weight cold in L2 (cycling through copies) and F.linear
    on copies of the dequantized weight beside it; the caption prompt's
    prefill (1152, 9216) by CUDA events as before. Then f32 x at the same
    shapes, f32 out, each version also against a float64 evaluation."""
    out = []
    cases = [(dtype, M, N, K) for dtype in (torch.bfloat16, torch.float32)
             for M, N, K in MP.w8a16_cases()
             if M <= 256 or N % 128 == 0 or dtype == torch.float32]
    for dtype, M, N, K in cases:
        (x, q8, sc), _, fl, _ = MP.w8a16_case(dtype, gen, M, N, K)
        y = torch.empty((M, N), device="cuda", dtype=dtype)
        w_lib = (q8.to(dtype) * sc[:, None]).to(dtype)
        code = 1 if dtype == torch.bfloat16 else 0

        def call(f, w=q8, x=x, sc=sc, y=y, M=M, N=N, K=K, code=code):
            return f(code, x.data_ptr(), w.data_ptr(), sc.data_ptr(), None,
                     y.data_ptr(), 0, M, N, K,
                     torch.cuda.current_stream().cuda_stream)
        timer = None
        if M <= 256:
            cold = M <= 16

            def timer(f, call=call, q8=q8, w_lib=w_lib, x=x, cold=cold):
                ws = _copies(q8) if cold else [q8]
                wl = _copies(w_lib) if cold else [w_lib]
                if f is None:
                    return graph_ms(lambda w: F.linear(x, w), wl)
                return graph_ms(lambda w: call(f, w), ws)
        tag = "" if dtype == torch.bfloat16 else " f32"
        ref64 = None if dtype == torch.bfloat16 else (
            lambda x=x, q8=q8, sc=sc: (x.double() @ q8.double().t())
            * sc.double())
        out.append((f"B12{tag} M{M} N{N} K{K}", "b12", call, y,
                    Q.w8a16_matmul_plain(x, q8, sc, None, dtype),
                    2 * M * N * K, lambda x=x, w=w_lib: F.linear(x, w),
                    ref64, timer))
    return out


def main() -> None:
    args = sys.argv[1:]
    only = None
    if args and args[0].startswith("--only="):
        only = tuple(args.pop(0)[len("--only="):].split(","))
    if not args or any("=" not in a for a in args):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    # float32 means float32 in the plain versions and library calls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    versions = [a.split("=", 1) for a in args]
    sources = _SOURCES if only is None else tuple(sorted({
        s for label in only for s in _LABEL_SOURCES[label.split()[0]]}))
    fns = {name: build_version(name, os.path.abspath(d), sources)
           for name, d in versions}
    order = [n for n, _ in versions]
    order += order[::-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, key, call, out, ref, flops, lib, ref64, timer in cases(gen):
        if only and not label.startswith(only):
            continue
        have = [n for n in fns if key in fns[n]]
        r64 = None if ref64 is None or not have else ref64()
        first = None
        for name in list(have):
            err = call(fns[name][key])
            if err:
                print(f"[skip] {name} {label}: refused, cudaError {err}")
                have.remove(name)
                continue
            torch.cuda.synchronize()
            got = (tuple(t.clone() for t in out) if isinstance(out, tuple)
                   else out.clone())
            same = ""
            if first is None:
                first = (name, got)
            else:
                eq = (all(torch.equal(a, b) for a, b in zip(got, first[1]))
                      if isinstance(got, tuple)
                      else torch.equal(got, first[1]))
                same = (f", bitwise {'equal' if eq else 'unlike'} "
                        f"{first[0]}'s")
            f64 = ("" if r64 is None else
                   f", against float64 {_rel(got, r64):.3e} "
                   f"(plain f32 {_rel(ref, r64):.3e})")
            print(f"[check] {name} {label}: max|err| / max|plain| "
                  f"{_rel(got, ref):.3e}{f64}{same}")
        del r64
        times = {}
        for name in [n for n in order if n in have]:
            times.setdefault(name, []).append(
                cuda_ms(lambda f=fns[name][key]: call(f)) if timer is None
                else timer(fns[name][key]))
        lib_ms = (None if lib is None else
                  cuda_ms(lib) if timer is None else timer(None))
        print(f"[time] {label}: " + "; ".join(
            f"{n} {', '.join(f'{t:.4f}' for t in ts)} ms "
            f"({flops / min(ts) / 1e9:.1f} TFLOP/s)"
            for n, ts in times.items())
            + ("" if lib_ms is None else
               f"; library {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} "
               f"TFLOP/s)"))


if __name__ == "__main__":
    main()
