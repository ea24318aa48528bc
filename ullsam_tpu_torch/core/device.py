"""The device that models are built on, and the CPU library's warm-up."""

from __future__ import annotations

import torch

_WARM_OPS = (torch.exp, torch.log, torch.tanh, torch.erf, torch.sigmoid,
             torch.rsqrt)
_warmed = False


def cpu_warmup() -> None:
    """Run each vectorized unary op the port uses once on one thread,
    before any multi-threaded call, then restore the thread count.

    On the CPU (torch 2.13 with MKL and OpenMP) the first multi-threaded
    ``exp`` of a process after a GEMM can come out wrong on one thread's
    half of the tensor, up to 1.5e-4 relative, while every later call is
    right; ``log``, ``tanh`` and ``erf`` do the same. One single-threaded
    call of each first removes it (fresh processes on an 8-core x86 CPU,
    eight at a time, a GEMM first: 4 of 96 differed between their first
    and second ``exp`` and 2-3 of 96 for ``log`` / ``tanh`` / ``erf``
    without it, none of 96 with it). Runs once per process."""
    global _warmed
    if _warmed:
        return
    _warmed = True
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x = torch.full((1 << 17,), 0.5)
        for op in _WARM_OPS:
            op(x)
    finally:
        torch.set_num_threads(threads)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises (it
    never falls back to the CPU). A CPU device runs ``cpu_warmup``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ullsam_tpu_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    if device.type == "cpu":
        cpu_warmup()
    return device
