"""Rank-0 logging helpers (the reference's logger(), train_joint_v2.py:44-46):
print on the main process only, the rank read from ``torch.distributed``
when a process group is initialised and 0 otherwise."""

from __future__ import annotations

import sys
import time

from ullsam_tpu_torch.parallel.distributed import is_main_process


def log0(*args, **kwargs) -> None:
    """Print only on rank 0 (timestamped, flushed)."""
    if is_main_process():
        print(time.strftime("[%H:%M:%S]"), *args, **kwargs, flush=True)


def warn0(*args) -> None:
    """Print a warning to stderr only on rank 0."""
    if is_main_process():
        print(time.strftime("[%H:%M:%S] WARNING:"), *args, file=sys.stderr,
              flush=True)
