"""Build the hand-written CUDA kernels from ``ullsam_tpu_torch/csrc`` at
first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o csrc/_build/<name>-<hash>.so <name>.cu

A build takes seconds (no PyTorch headers). ``build_all`` starts one nvcc
per source at once and waits for all of them; the ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside each library.
The hash covers the sources and flags, so an edited source rebuilds.
Nothing is downloaded and no prebuilt kernel package is used.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
SOURCES = ("window_attn", "vit_flash_attn", "decoder_twt", "decoder_upscale",
           "decoder_image", "window_attn_bwd", "vit_flash_bwd",
           "llm_flash_attn", "llm_flash_bwd", "w8a16_matmul", "ln_mlp",
           "window_attn_twophase")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "ullsam_tpu_torch need the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
            os.path.join(CSRC, name + ".cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the current build of ``name``."""
    path = lib_path(name)[:-3] + ".ptxas.txt"
    with open(path) as f:
        return f.read()


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; return name -> .so path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        with open(out[:-3] + ".ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            _libs[name] = lib
        return lib


def loaded(name: str) -> bool:
    """Whether library ``name`` has been loaded in this process."""
    return name in _libs


def function(lib: str, name: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``name`` of library ``lib`` with its argument and
    result types declared (pointers and the stream as c_void_p, so ctypes
    never cuts them to 32 bits); bound once, then cached."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes, fn.restype = argtypes, restype
        _fns[(lib, name)] = fn
    return fn


def aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernels take their
    operands (a gradient handed to a backward may be a strided or offset
    view); copies only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
