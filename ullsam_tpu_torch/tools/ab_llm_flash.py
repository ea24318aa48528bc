"""A/B timing of the LLM flash kernels B10 and B11 built from several source
trees, in one process on one card, so that versions compare within one
call (two calls may land on two cards).

    python -m ullsam_tpu_torch.tools.ab_llm_flash NAME=CSRC_DIR [...]

Each CSRC_DIR holds ``llm_flash_attn.cu``, ``llm_flash_bwd.cu`` and the
headers they include: a checkout's ``ullsam_tpu_torch/csrc``, or another
commit's unpacked by ``git archive`` into a directory that git ignores.
Each version is built with ``build.NVCC_FLAGS`` under ``csrc/_build/ab/``
(each kernel's ptxas registers and spill bytes printed), checked against
the plain versions at the packed sft path's shape (``tools/main_path.py``
``LLM_FLASH``) in bf16 and f32, then timed by CUDA events in the order
given and again in reverse (a, b, ..., b, a). An entry whose C source
takes ``void* scratch`` gets one: the backward's of
``llm_flash_attention.bwd_scratch_floats`` (bf16's f32 dq sums, float32's
split planes), the forward's of ``fwd_scratch_floats`` (float32's split
planes). Each version's outputs are compared bitwise with the first
version's (bf16 dq by the count of elements that differ, beside the first
version's own count between two of its calls: its f32 sums land in an
order that varies), in float32 also with a second call of the same
version, and in float32 each output's error against a float64 evaluation
of the plain version is printed beside the plain float32 version's own.
Needs a CUDA card.
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
_ENTRIES = {"llm_flash_attn": "llm_flash_attn_forward",
            "llm_flash_bwd": "llm_flash_attn_backward"}


def _argtypes(src: str, scratch: bool) -> list:
    """The C entry's: the pointers (the forward's 7, the backward's 11, and
    a scratch where the source takes one), 6 ints, scale, stream."""
    ptrs = (7 if src == "llm_flash_attn" else 11) + int(scratch)
    return [_I] + [_P] * ptrs + [_I] * 6 + [ctypes.c_float, _P]


def ptxas_lines(log: str) -> list:
    """"kernel: R registers, S/L spill bytes" for each entry function of an
    ``nvcc -Xptxas -v`` log (mangled names shortened to their identifier)."""
    out, fn, spills = [], None, "0/0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            # the identifier after the anonymous namespace, length-prefixed
            n = re.search(r"_GLOBAL__N_1(\d+)", fn)
            if n:
                at = n.end()
                fn = fn[at:at + int(n.group(1))] + "".join(
                    f"<{d}>" for d in re.findall(r"ILi(\d+)E", fn[at:])[:1])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{fn}: {m.group(1)} registers, {spills} spill bytes")
            fn, spills = None, "0/0"
    return out


def build_version(name: str, csrc: str) -> dict:
    """{source: (the bound C entry, whether it takes a scratch)} of the two
    sources in ``csrc``, built in parallel into csrc/_build/ab/<name>/."""
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
        print(f"[build] {name} {src}: " + "; ".join(ptxas_lines(log))
              + f"; {log.count('C7515')} C7515 advisories")
        with open(os.path.join(csrc, src + ".cu")) as f:
            scratch = "void* scratch" in f.read()
        fn = getattr(ctypes.CDLL(os.path.join(out, src + ".so")),
                     _ENTRIES[src])
        fn.argtypes, fn.restype = _argtypes(src, scratch), ctypes.c_int
        fns[src] = (fn, scratch)
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


def device_ops(fn, iters: int = 10) -> str:
    """"op ms (count)" of each device operation one call of fn runs, from
    torch.profiler over iters calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            name = re.sub(r"\(.*", "", e.key.replace(
                "(anonymous namespace)::", "")).removeprefix("void ")
            ms, n = us / iters / 1e3, e.count // iters
            rows.append((us, f"{name.split('::')[-1][:48]} {ms:.4f} ms ({n})"))
    return "; ".join(r for _, r in sorted(rows, reverse=True))


def main() -> None:
    args = sys.argv[1:]
    if not args or any("=" not in a for a in args):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
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
        q_scale = LF.q_scale(D, dtype)  # what the forward wrapper passes
        o, lse = torch.empty_like(q), torch.empty(B, nh, S, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        scratch = {
            "llm_flash_attn": torch.empty(LF.fwd_scratch_floats(
                B, S, nh, nkv, D, dtype), device="cuda"),
            "llm_flash_bwd": torch.empty(LF.bwd_scratch_floats(
                B, S, nh, nkv, D, dtype), device="cuda")}
        stream = torch.cuda.current_stream().cuda_stream

        def call(name, src):
            f, takes_scratch = fns[name][src]
            if src == "llm_flash_attn":
                ptrs = [q, k, v, seg, seg, o, lse]
            else:
                ptrs = [q, k, v, seg, seg, do, lse_in, dd, dq, dk, dv]
            if takes_scratch:
                ptrs.append(scratch[src])
            ptrs = [t.data_ptr() for t in ptrs]
            sc = q_scale if src == "llm_flash_attn" else scale
            return lambda: f(code, *ptrs, B, S, nh, nkv, D, 1, sc, stream)

        def outputs(name):
            if call(name, "llm_flash_attn")() or call(name, "llm_flash_bwd")():
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            return [t.clone() for t in (o, lse, dq, dk, dv)]

        ref = (*LF.llm_flash_attn_plain(q, k, v, seg, seg, nkv),
               *LF.llm_flash_attn_bwd_plain(q, k, v, seg, seg, do, lse_in,
                                            dd, nkv))
        dn = str(dtype).replace("torch.", "")
        names = ("o", "lse", "dq", "dk", "dv")
        first = None
        if dtype == torch.float32:
            r64 = (*LF.llm_flash_attn_plain(
                *(t.double() for t in (q, k, v)), seg, seg, nkv),
                *LF.llm_flash_attn_bwd_plain(
                    *(t.double() for t in (q, k, v)), seg, seg, do.double(),
                    lse_in.double(), dd.double(), nkv))
            plain64 = [float((a.double() - r).abs().max() / r.abs().max())
                       for a, r in zip(ref, r64)]
        for name in fns:
            got = outputs(name)
            errs = [float((a.float() - b.float()).abs().max()
                          / b.float().abs().max()) for a, b in zip(got, ref)]
            print(f"[check] {name} {dn}: max|err| / max|plain| of o, lse, "
                  f"dq, dk, dv: {', '.join(f'{e:.2e}' for e in errs)}")
            again = outputs(name)
            if first is None:
                first = got
                diff = [int((a != b).sum()) for a, b in zip(got, again)]
                print(f"[check] {name} {dn}: elements differing between two "
                      f"calls of {', '.join(names)}: {diff}")
            else:
                diff = [int((a != b).sum()) for a, b in zip(got, first)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print(f"[check] {name} {dn}: elements differing from "
                      f"{order[0]}'s of {', '.join(names)}: {diff} (of "
                      f"{', '.join(str(t.numel()) for t in got)}); two calls "
                      f"bitwise equal: {same}")
            if dtype == torch.float32:
                e64 = [float((a.double() - r).abs().max() / r.abs().max())
                       for a, r in zip(got, r64)]
                ratio = [a / b for a, b in zip(e64, plain64)]
                print(f"[f64] {name} {dn}: max|err| / max|f64| of "
                      f"{', '.join(names)}: kernel "
                      f"{', '.join(f'{e:.3e}' for e in e64)}; plain f32 "
                      f"{', '.join(f'{e:.3e}' for e in plain64)}; ratio "
                      f"{', '.join(f'{r:.2f}' for r in ratio)}")
            del got, again
        del first
        if dtype == torch.float32:
            del r64
        for src, kind, fl in (("llm_flash_attn", "B10", flops["fwd"]),
                              ("llm_flash_bwd", "B11", flops["bwd"])):
            times = {}
            for name in order:
                times.setdefault(name, []).append(cuda_ms(call(name, src)))
            print(f"[time] {kind} {dn}: " + "; ".join(
                f"{n} {', '.join(f'{t:.4f}' for t in ts)} ms "
                f"({fl / min(ts) / 1e9:.1f} TFLOP/s of the same-segment "
                f"work)" for n, ts in times.items()))
            for name in fns:
                print(f"[ops] {kind} {dn} {name}: "
                      + device_ops(call(name, src)))


if __name__ == "__main__":
    main()
