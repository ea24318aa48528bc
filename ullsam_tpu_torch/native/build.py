"""Build the native host-ops library (g++, no dependencies).

Compiled at first use into ``_build/`` beside this file (ignored by git),
keyed by the hash of the source and the flags, so an edited source builds
anew and an unchanged one is built once. ``python -m ullsam_tpu_torch.native.build``
builds eagerly and prints the library's path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")


FLAGS = (["-O3", "-march=x86-64-v2"], ["-O3"])   # tried in this order


def _src_hash() -> str:
    """The source's and the flags' hash: either changed builds anew."""
    with open(SRC, "rb") as f:
        return hashlib.sha256(f.read() + repr(FLAGS).encode()
                              ).hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libhost_ops_{_src_hash()}.so")


def build(verbose: bool = False) -> str:
    """Compile if needed and return the ``.so`` path. Tries ``-O3
    -march=x86-64-v2`` (a hardware popcount, on any x86-64 server of the
    last decade, so a library built on one host runs on another), then
    ``-O3``; raises ``RuntimeError`` carrying g++'s error output when both
    fail. Concurrent builds each write a file of their own and rename it
    into place."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    errors = []
    for flags in FLAGS:
        cmd = (["g++"] + flags
               + ["-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp])
        if verbose:
            print(" ".join(cmd))
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:          # no g++ on the PATH
            errors.append(f"{' '.join(cmd)}: {e}")
            break
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{' '.join(cmd)}:\n{proc.stderr.strip()}")
    raise RuntimeError("g++ build of the native host ops failed:\n"
                       + "\n".join(errors))


if __name__ == "__main__":
    print(build(verbose=True))
