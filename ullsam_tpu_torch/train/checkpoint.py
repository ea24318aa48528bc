"""Checkpoints with a true resume (``ullsam_tpu/train/checkpoint.py``).

The reference saves {model, optimizer, scheduler, epoch, step, args} but
never restores the optimizer or scheduler (train_joint_v2.py:1247-1264), so
a resume restarts the schedule. Here a checkpoint holds the trainable
parameters, the optimizer's whole state (AdamW's ``mu``, ``nu`` and count,
and under ``MultiSteps`` the micro-step and the accumulator) and an
``extra`` JSON dict: resuming, even between the micro-steps of one
accumulation, continues as if the run had never stopped.

Layout, as orbax's: ``<directory>/<step>/state.pt`` (``torch.save`` of
{"params", "opt_state"}, CPU tensors) and ``<directory>/<step>/extra.json``.
Each step is written under a temporary name and renamed into place, on a
background thread after the tensors were copied to the host; a step at or
below the newest one is not saved again (orbax's default policy); the
newest ``max_to_keep`` steps are kept.

``save_params_npz`` / ``load_params_npz`` read and write the JAX package's
flat ``.npz`` (its param paths and layouts), so a file of either package
loads in the other.

Under data and tensor parallelism (``parallel/``) ``save_state`` gathers
every sharded tensor whole (a collective on every rank), rank 0 writes and
all ranks meet at a barrier; ``restore_state`` loads the whole tensors on
every rank and keeps each rank's shard. A checkpoint is thus independent
of the layout that wrote it, as orbax's global arrays are.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ullsam_tpu_torch.parallel import distributed as D
from ullsam_tpu_torch.parallel.partitioning import full_tensor, local_shard

_TMP = ".tmp-"


def _to_host(tree: Any) -> Any:
    """Nested dicts of tensors -> copies on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if _TMP in name:  # a save cut short
                shutil.rmtree(os.path.join(self.directory, name))
        self._steps = sorted(int(n) for n in os.listdir(self.directory)
                             if n.isdigit())
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, state: dict, extra: dict,
               drop: list) -> None:
        try:
            final = os.path.join(self.directory, str(step))
            tmp = f"{final}{_TMP}{os.getpid()}"
            os.makedirs(tmp)
            torch.save(state, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra, f)
            os.rename(tmp, final)
            for old in drop:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        except Exception as e:  # raised by the next save / close
            self._error = e

    def save(self, step: int, params: Dict[str, torch.Tensor],
             opt_state: dict, extra: Optional[dict] = None,
             wait: bool = False) -> bool:
        """Save ``params`` (name -> tensor) and ``opt_state`` (the
        optimizer's ``state_dict()``) at ``step``. The tensors are copied
        to the host before this returns; the file is written on a
        background thread unless ``wait``. Returns False, saving nothing,
        when ``step`` is not past the newest step."""
        self._wait()
        if self._steps and step <= self._steps[-1]:
            return False
        state = _to_host({"params": params, "opt_state": opt_state})
        self._steps.append(step)
        drop = self._steps[:-self.max_to_keep]
        self._steps = self._steps[-self.max_to_keep:]
        self._writer = threading.Thread(
            target=self._write,
            args=(step, state, dict(extra or {}), drop), daemon=True)
        self._writer.start()
        if wait:
            self._wait()
        return True

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def restore(self, step: Optional[int] = None, map_location="cpu"
                ) -> Tuple[Dict[str, torch.Tensor], dict, dict]:
        """(params, opt_state, extra) of ``step`` (default: the newest)."""
        self._wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, str(step))
        state = torch.load(os.path.join(d, "state.pt"),
                           map_location=map_location, weights_only=True)
        with open(os.path.join(d, "extra.json")) as f:
            extra = json.load(f)
        return state["params"], state["opt_state"], extra

    def close(self) -> None:
        self._wait()


_SHARDED_STATE = ("mu", "nu", "acc")   # per-parameter optimizer state


def _map_state(opt, state: dict, fn) -> dict:
    """``state`` with each per-parameter tensor replaced by ``fn(tensor,
    its parameter)``."""
    like = dict(zip(opt.names, opt.params))
    return {k: ({n: fn(t, like[n]) for n, t in v.items()}
                if k in _SHARDED_STATE else v) for k, v in state.items()}


def save_state(ckpt: CheckpointManager, step: int, opt,
               extra: Optional[dict] = None, wait: bool = False) -> bool:
    """Save ``opt``'s parameters and state whole at ``step``: every rank
    gathers, rank 0 writes (``CheckpointManager.save``), all meet at a
    barrier. Returns whether rank 0 saved."""
    params = {n: full_tensor(p) for n, p in zip(opt.names, opt.params)}
    state = _map_state(opt, opt.state_dict(), full_tensor)
    saved = False
    if D.is_main_process():
        saved = ckpt.save(step, params, state, extra=extra, wait=wait)
    D.barrier()
    return saved


@torch.no_grad()
def restore_state(ckpt: CheckpointManager, opt, map_location="cpu",
                  step: Optional[int] = None) -> dict:
    """Load a checkpoint into ``opt``'s parameters and state on every rank,
    each keeping its shard; returns the ``extra`` dict."""
    params, state, extra = ckpt.restore(step, map_location=map_location)
    for name, p in zip(opt.names, opt.params):
        p.copy_(local_shard(params[name], p))
    opt.load_state_dict(_map_state(opt, state, local_shard))
    return extra


def save_params_npz(path: str, model: torch.nn.Module) -> None:
    """A ``ULLSAM``'s parameters as the JAX package's flat ``.npz``
    (``convert.from_jax.jax_param_arrays``; floats as float32)."""
    from ullsam_tpu_torch.convert.from_jax import jax_param_arrays

    np.savez(path, **jax_param_arrays(model))


def load_params_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flat ``.npz`` of JAX param paths (either package's
    ``save_params_npz``) into a ``ULLSAM``, in its dtype and device."""
    from ullsam_tpu_torch.convert.from_jax import (fusion_state_dict_from_jax,
                                                   unflatten_paths)

    with np.load(path) as z:
        tree = unflatten_paths({k: z[k] for k in z.files})
    sd = fusion_state_dict_from_jax(tree, model.cfg)
    own = model.state_dict()
    model.load_state_dict({k: v.to(dtype=own[k].dtype, device=own[k].device)
                           for k, v in sd.items()})
    return model
