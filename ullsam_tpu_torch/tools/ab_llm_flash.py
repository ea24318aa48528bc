"""A/B timing of the LLM flash kernels B10 and B11 built from several source
trees, in one process on one card, so that versions compare within one
call (two calls may land on two cards).

    python -m ullsam_tpu_torch.tools.ab_llm_flash NAME=CSRC_DIR [...]

Each CSRC_DIR holds ``llm_flash_attn.cu``, ``llm_flash_bwd.cu`` and the
headers they include: a checkout's ``ullsam_tpu_torch/csrc``, or another
commit's unpacked by ``git archive`` into a directory that git ignores.
Each version is built with ``build.NVCC_FLAGS`` under ``csrc/_build/ab/``
(its ptxas registers and spills printed), checked against the plain
versions at the packed sft path's shape (``tools/main_path.py``
``LLM_FLASH``) in bf16 and f32, then timed by CUDA events in the order
given and again in reverse (a, b, ..., b, a). Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
from ullsam_tpu_torch.tools.main_path import LLM_FLASH, llm_flash_case

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"llm_flash_attn": ("llm_flash_attn_forward",
                               [_I] + [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]),
            "llm_flash_bwd": ("llm_flash_attn_backward",
                              [_I] + [_P] * 11 + [_I] * 6
                              + [ctypes.c_float, _P])}


def build_version(name: str, csrc: str) -> dict:
    """{source: the bound C entry} of the two sources in ``csrc``, built in
    parallel into csrc/_build/ab/<name>/."""
    out = os.path.join(build.BUILD_DIR, "ab", name)
    os.makedirs(out, exist_ok=True)
    procs = {src: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc, "-o",
         os.path.join(out, src + ".so"), os.path.join(csrc, src + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in _ENTRIES}
    fns = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name} {src}: registers {regs}, spill stores "
              f"{spills}")
        fn_name, argtypes = _ENTRIES[src]
        fn = getattr(ctypes.CDLL(os.path.join(out, src + ".so")), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[src] = fn
    return fns


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
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


def main() -> None:
    args = sys.argv[1:]
    if not args or any("=" not in a for a in args):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    versions = [a.split("=", 1) for a in args]
    fns = {name: build_version(name, os.path.abspath(d))
           for name, d in versions}
    order = [n for n, _ in versions]
    order += order[::-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        code = 1 if dtype == torch.bfloat16 else 0
        fwd, bwd, kw, flops, _ = llm_flash_case(dtype, gen, **LLM_FLASH)
        q, k, v, seg, _ = fwd
        do, lse_in, dd = bwd[5:]
        B, S, nh, D = q.shape
        nkv, scale = k.shape[2], float(D ** -0.5)
        o, lse = torch.empty_like(q), torch.empty(B, nh, S, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream

        def call(name, src):
            f = fns[name][src]
            if src == "llm_flash_attn":
                return lambda: f(code, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), seg.data_ptr(), seg.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), B, S, nh, nkv,
                                 D, 1, scale, stream)
            return lambda: f(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             seg.data_ptr(), seg.data_ptr(), do.data_ptr(),
                             lse_in.data_ptr(), dd.data_ptr(), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), B, S, nh, nkv, D,
                             1, scale, stream)

        ref = (*LF.llm_flash_attn_plain(q, k, v, seg, seg, nkv),
               *LF.llm_flash_attn_bwd_plain(q, k, v, seg, seg, do, lse_in,
                                            dd, nkv))
        dn = str(dtype).replace("torch.", "")
        for name in fns:
            if call(name, "llm_flash_attn")() or call(name, "llm_flash_bwd")():
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).abs().max()
                          / b.float().abs().max())
                    for a, b in zip((o, lse, dq, dk, dv), ref)]
            print(f"[check] {name} {dn}: max|err| / max|plain| of o, lse, "
                  f"dq, dk, dv: {', '.join(f'{e:.2e}' for e in errs)}")
        for src, kind, fl in (("llm_flash_attn", "B10", flops["fwd"]),
                              ("llm_flash_bwd", "B11", flops["bwd"])):
            times = {}
            for name in order:
                times.setdefault(name, []).append(cuda_ms(call(name, src)))
            print(f"[time] {kind} {dn}: " + "; ".join(
                f"{n} {', '.join(f'{t:.4f}' for t in ts)} ms "
                f"({fl / min(ts) / 1e9:.1f} TFLOP/s of the same-segment "
                f"work)" for n, ts in times.items()))


if __name__ == "__main__":
    main()
