"""The segmentation train step (``ullsam_tpu/train/step.py``): fused
forward -> per-instance point-prompted decode -> fused upsample + BCE +
Dice -> clip by global norm -> AdamW with the warmup-cosine schedule.

The SAM tower, mlp1 and mlp2 train; the InternLM2 is frozen
(``requires_grad_(False)``) while activation gradients flow through all of
its layers (the dense-prompt path mlp1 -> LLM -> mlp2). Parameters and
moments are updated in place (the JAX step returns new trees).

The optimizer is written out as plain tensor arithmetic so that it follows
optax's ``chain(clip_by_global_norm, adamw(schedule, mask=decay))``:

* the schedule is evaluated at the count before the step, so step 1 runs
  at lr = 0 (``warmup_cosine_decay_schedule(init_value=0, ...)``);
* the clip multiplies by max_norm / norm only when norm >= max_norm (no
  epsilon, unlike ``clip_grad_norm_``);
* ``metrics["grad_norm"]`` is the norm before the clip;
* the moments keep the parameters' dtype (bf16 training keeps bf16
  moments, as the JAX step does with bf16 params); the global norm is
  summed in f32.

Which parameters train and which decay is decided on the JAX package's
param paths (``convert.from_jax.jax_param_paths``), with its regexes.

``grad_accum`` > 1 wraps the optimizer in ``MultiSteps``, which follows
``optax.MultiSteps`` (``optax/transforms/_accumulation.py``): each
micro-step folds its gradients into a running mean (Welford, in the
gradients' dtype); on micro-step k the clip and AdamW run on the mean and
the mean resets; the other micro-steps leave the parameters as they are.
``instance_matching="hungarian"`` re-matches predictions to ground truths
by soft IoU before the loss (``losses.hungarian_instance_loss``).

Data and tensor parallelism follow the model's ``mesh``
(``parallel/partitioning.py`` ``shard_params``; take the optimizer after
it). The losses divide by each rank's share of the whole batch's valid
counts; ``train_step`` replaces the gradients by their mean over the data
group before the optimizer (on every micro-step of ``MultiSteps``, since
the mean is linear) and the metrics by theirs, so every rank of a data
group takes the same update. Under tensor parallelism ``global_norm``
counts a sharded tensor's squares over its shards (an all-reduce over the
model group) and a replicated tensor's once.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ullsam_tpu_torch.convert.from_jax import jax_param_paths
from ullsam_tpu_torch.core.config import FusionConfig
from ullsam_tpu_torch.models.ullsam import fusion as F
from ullsam_tpu_torch.ops.resize import bilinear_resize
from ullsam_tpu_torch.parallel import distributed as D
from ullsam_tpu_torch.parallel.partitioning import (is_sharded,
                                                    mean_over_data,
                                                    sync_grads)
from ullsam_tpu_torch.train.losses import (hungarian_instance_loss,
                                           upsampled_instance_seg_loss)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """A copy of the JAX package's TrainConfig, with the same defaults."""
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    total_steps: int = 10000
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0
    seg_weight: float = 1.0
    llm_weight: float = 0.0
    trainable_patterns: Tuple[str, ...] = (r"sam\..*", r"mlp1\..*",
                                           r"mlp2\..*")
    no_decay_patterns: Tuple[str, ...] = (
        r".*\.bias", r".*norm.*", r".*\.scale", r".*ln.*", r".*pos_embed.*",
        r".*rel_pos.*", r".*embed.*")
    use_llm_hidden_states: bool = True
    freeze_vision: bool = False
    remat: bool = True
    remat_llm: Optional[bool] = None
    instance_matching: str = "indexed"


def _match_any(path: str, patterns) -> bool:
    return any(re.fullmatch(p, path) for p in patterns)


def trainable_mask(model: torch.nn.Module, tcfg: TrainConfig
                   ) -> Dict[str, bool]:
    """{parameter name: trains}, from the JAX patterns on the JAX paths."""
    pats = list(tcfg.trainable_patterns)
    if tcfg.freeze_vision:
        pats = [p for p in pats if not p.startswith(r"sam\.")]
    return {n: _match_any(p, pats) for n, p in jax_param_paths(model).items()}


def decay_mask(model: torch.nn.Module, tcfg: TrainConfig) -> Dict[str, bool]:
    """{parameter name: weight decay applies}."""
    return {n: not _match_any(p, tcfg.no_decay_patterns)
            for n, p in jax_param_paths(model).items()}


def lr_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, 0):
    linear from 0 over the warmup, then a cosine to 0 at decay_steps."""
    warmup = max(1, int(tcfg.total_steps * tcfg.warmup_ratio))
    decay_steps = max(tcfg.total_steps, warmup + 1)
    peak = tcfg.learning_rate

    def lr(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay_steps - warmup)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps
                                                          - warmup)))
    return lr


class AdamW:
    """clip_by_global_norm(max_grad_norm) -> adamw(schedule, b1 0.9, b2
    0.999, eps 1e-8, weight_decay, mask=decay) over the trainable
    parameters, updated in place."""

    def __init__(self, model: torch.nn.Module, tcfg: TrainConfig,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        train, decay = trainable_mask(model, tcfg), decay_mask(model, tcfg)
        named = [(n, p) for n, p in model.named_parameters() if train[n]]
        self.names = [n for n, _ in named]
        self.params: List[Tensor] = [p for _, p in named]
        self.decayed = [p for n, p in named if decay[n]]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.tcfg, self.b1, self.b2, self.eps = tcfg, b1, b2, eps
        self.schedule = lr_schedule(tcfg)
        self.mesh = getattr(model, "mesh", None)
        self.sharded = [is_sharded(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[Tensor]) -> Tensor:
        """Apply one update from ``grads`` (one per trainable parameter, in
        ``self.names`` order); returns the global norm before the clip."""
        b1, b2, tcfg = self.b1, self.b2, self.tcfg
        g_norm = global_norm(grads, self.sharded, self.mesh)
        clip = torch.where(g_norm < tcfg.max_grad_norm,
                           torch.ones_like(g_norm),
                           tcfg.max_grad_norm / g_norm)
        g = torch._foreach_mul(grads, clip)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - b2)
        self.count += 1
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, den)
        ids = {id(p) for p in self.decayed}
        dec = [(u, p) for u, p in zip(upd, self.params) if id(p) in ids]
        if dec and tcfg.weight_decay:
            torch._foreach_add_([u for u, _ in dec], [p for _, p in dec],
                                alpha=tcfg.weight_decay)
        torch._foreach_add_(self.params, upd,
                            alpha=-self.schedule(self.count - 1))
        return g_norm


    def state_dict(self) -> dict:
        """The moments by parameter name and the count (what a checkpoint
        keeps; the parameters themselves are saved beside it)."""
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])
        self.count = int(state["count"])


def global_norm(tensors: List[Tensor], sharded: Optional[List[bool]] = None,
                mesh=None) -> Tensor:
    """sqrt of the sum of squares of every element, summed in f32. Where
    ``sharded`` marks tensors split over ``mesh``'s model group, their
    squares are summed over the group and the others' counted once."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    group = None if mesh is None else mesh.model_group
    if group is None or not any(sharded or ()):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    mask = torch.tensor(sharded, device=sq.device)
    split = D.all_reduce_(sq[mask].sum(), group)
    return torch.sqrt(sq[~mask].sum() + split)


class MultiSteps:
    """Gradient accumulation over ``every_k`` micro-steps around ``inner``
    (``optax.MultiSteps(inner, every_k_schedule=k)``, its defaults: the
    mean, no skipping). The accumulator keeps the gradients' dtype, so
    bf16 training accumulates in bf16 as the JAX step does."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner, self.every_k = inner, every_k
        self.names, self.params = inner.names, inner.params
        self.mesh, self.sharded = inner.mesh, inner.sharded
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in inner.params]

    @torch.no_grad()
    def step(self, grads: List[Tensor]) -> Tensor:
        """Fold one micro-batch's ``grads`` into the mean (acc += (g - acc)
        / (n + 1)); on the k-th micro-step clip + AdamW on the mean (its
        count advances) and reset it. Returns the micro-batch's own global
        norm (``metrics["grad_norm"]``)."""
        g_norm = global_norm(grads, self.sharded, self.mesh)
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(self.acc, diff)
        if self.mini_step == self.every_k - 1:
            self.inner.step(self.acc)
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        else:
            self.mini_step += 1
        return g_norm

    def state_dict(self) -> dict:
        return {**self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": dict(zip(self.names, self.acc))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)
        for name, a in zip(self.names, self.acc):
            a.copy_(state["acc"][name])
        self.mini_step = int(state["mini_step"])


def make_trainable_optimizer(model: torch.nn.Module, tcfg: TrainConfig,
                             grad_accum: int = 1):
    """Freeze what does not train (``requires_grad_(False)``: no gradient is
    kept for it, activations still carry theirs) and return the optimizer
    over what does: ``AdamW``, wrapped in ``MultiSteps`` when grad_accum >
    1 (the reference trains with accumulation 8,
    train_joint_v2.py:1584,1169-1188)."""
    train = trainable_mask(model, tcfg)
    for n, p in model.named_parameters():
        p.requires_grad_(train[n])
    opt = AdamW(model, tcfg)
    return MultiSteps(opt, grad_accum) if grad_accum > 1 else opt


def batch_on(model: torch.nn.Module, batch: dict) -> dict:
    """The batch (numpy arrays or tensors) as tensors on the model's device
    in the step's dtypes; tensors already there are not copied."""
    dev = next(model.parameters()).device
    kinds = {"pixel_values": torch.float32, "point_coords": torch.float32,
             "masks": torch.float32, "instance_valid": torch.float32}
    return {k: torch.as_tensor(v, device=dev, dtype=kinds.get(k, torch.long))
            for k, v in batch.items() if v is not None}


def _low_res_masks(model: F.ULLSAM, cfg: FusionConfig, out: dict,
                   batch: dict) -> Tensor:
    """Per image: the per-instance point prompts against its features and
    dense prompt -> low-res logits [B, I, 4h, 4w] (mask token 0)."""
    dense = out.get("dense_prompt")
    feats = out["image_embeddings"]
    lows = []
    for b in range(feats.shape[0]):
        low, _ = F.segment_with_prompts(
            model, cfg, feats[b:b + 1],
            None if dense is None else dense[b:b + 1],
            batch["point_coords"][b], batch["point_labels"][b],
            multimask_output=False)
        lows.append(low[:, 0])
    return torch.stack(lows)


def seg_loss_fn(model: F.ULLSAM, cfg: FusionConfig, tcfg: TrainConfig,
                batch: dict) -> Tuple[Tensor, dict]:
    """Loss of one batch: pixel_values [B, S, S, 3], input_ids [B, N],
    attention_mask [B, N], labels [B, N] (optional), point_coords
    [B, I, P, 2], point_labels [B, I, P], masks [B, I, Hm, Wm],
    instance_valid [B, I]. Returns (total, metrics). A packed batch
    (``data/packing.py``; the language-only modes) carries segment_ids
    [B, N] in place of attention_mask and all its images in pixel_values
    [n_images, S, S, 3]."""
    batch = batch_on(model, batch)
    mesh = getattr(model, "mesh", None)
    seg = tcfg.seg_weight != 0.0
    out = F.fusion_forward(
        model, cfg, batch["pixel_values"], batch["input_ids"],
        attention_mask=batch.get("attention_mask"),
        labels=batch.get("labels"), segment_ids=batch.get("segment_ids"),
        output_dense_prompt=tcfg.use_llm_hidden_states and seg,
        stop_vision_gradient=False, remat=tcfg.remat,
        remat_llm=(tcfg.remat_llm if tcfg.remat_llm is not None
                   else (tcfg.remat if not seg else False)))
    if not seg:
        metrics = {"llm_loss": out["loss"], "loss": out["loss"]}
        return out["loss"] * tcfg.llm_weight, metrics
    low = _low_res_masks(model, cfg, out, batch)
    if tcfg.instance_matching == "hungarian":
        Hm, Wm = batch["masks"].shape[-2:]
        seg_loss, metrics = hungarian_instance_loss(
            bilinear_resize(low.float(), Hm, Wm), batch["masks"],
            batch.get("instance_valid"), mesh=mesh)
    else:
        seg_loss, metrics = upsampled_instance_seg_loss(
            low, batch["masks"], batch.get("instance_valid"), mesh=mesh)
    total = tcfg.seg_weight * seg_loss
    if tcfg.llm_weight and "loss" in out:
        total = total + tcfg.llm_weight * out["loss"]
    if "loss" in out:
        metrics["llm_loss"] = out["loss"]
    metrics["loss"] = total
    return total, metrics


def train_step(model: F.ULLSAM, opt, batch: dict, cfg: FusionConfig,
               tcfg: TrainConfig) -> dict:
    """One step of ``opt`` (``AdamW``, or a micro-step of ``MultiSteps``)
    over the trainable parameters; returns the metrics (0-d tensors on the
    model's device, no host sync). Under a mesh with a data group the
    gradients and the metrics are first averaged over it."""
    for p in opt.params:
        p.grad = None
    total, metrics = seg_loss_fn(model, cfg, tcfg, batch)
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in opt.params]
    mesh = getattr(model, "mesh", None)
    sync_grads(grads, mesh)
    metrics = mean_over_data({k: v.detach() for k, v in metrics.items()},
                             mesh)
    metrics["grad_norm"] = opt.step(grads)
    return metrics


def make_train_step(cfg: FusionConfig, tcfg: TrainConfig, model: F.ULLSAM,
                    opt) -> Callable[[dict], dict]:
    """step(batch) -> metrics, updating ``model`` and ``opt`` in place."""

    def step(batch: dict) -> dict:
        return train_step(model, opt, batch, cfg, tcfg)

    return step


def make_pred_masks_fn(cfg: FusionConfig, tcfg: TrainConfig):
    """fn(model, batch) -> predicted instance-mask logits [B, I, Hm, Wm]
    (f32) at the ground truth's size, by the seg path without the loss
    (one extra forward, for visualisation)."""

    @torch.no_grad()
    def fn(model: F.ULLSAM, batch: dict) -> Tensor:
        batch = batch_on(model, batch)
        out = F.fusion_forward(
            model, cfg, batch["pixel_values"], batch["input_ids"],
            attention_mask=batch.get("attention_mask"),
            output_dense_prompt=tcfg.use_llm_hidden_states,
            stop_vision_gradient=True, remat=False)
        low = _low_res_masks(model, cfg, out, batch)
        Hm, Wm = batch["masks"].shape[-2:]
        return bilinear_resize(low.float(), Hm, Wm)

    return fn
