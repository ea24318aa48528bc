"""The ("data", "model") mesh and the parameter sharding rules
(``ullsam_tpu/parallel/partitioning.py``).

``PARAM_RULES`` are the JAX package's rules over the port's reference
names. JAX stores a linear's kernel [in, out] (stacked [L, in, out] in the
LLM), torch its weight [out, in], so each spec is the JAX spec with the
layer axis dropped and the two dimensions swapped
(``tests/test_torch_parallel.py`` checks every rule against JAX's
``param_spec``). ``_fit_spec`` replicates a dimension that the model axis
does not divide, such as the 92,553-entry vocab (3 x 30,851) at tp 2, 4
or 8.

What a rank does with its shard, rule by rule:

* InternLM2 ``wqkv``, ``w1``, ``w3`` (column-parallel) and ``wo``, ``w2``
  (row-parallel), and the projectors' ``mlp1`` / ``mlp2`` ``fc1`` (column)
  and ``fc2`` (row): Megatron tensor parallelism. The layer computes on its
  own heads or hidden units and sums the row-parallel product over the
  model group (``distributed.copy_to_model`` / ``row_parallel_linear``).
  ``wqkv`` is packed per kv group, so its contiguous split is a split by
  kv groups; ``num_key_value_heads % tp == 0`` is required. A module whose
  weights the axis does not all divide stays whole.
* The SAM ViT ``qkv``, ``proj``, ``mlp.lin1`` and ``mlp.lin2``: gathered
  before the block runs (``distributed.gathered``), so B1, B2, B13 and B14
  take whole weights and every rank computes the whole block, as each TPU
  device computes the JAX package's Pallas calls over sharded operands.
  JAX's contiguous column halves of ``qkv`` are a storage layout (the first
  half holds all of q and half of k), not a split by heads, so a local
  product on that shard would be wrong. The numbers are the one-process
  ones; the storage is sharded.
* The token embedding and the vocab head, where the axis divides the
  vocab: gathered when the module is called. At 92,553 they stay whole.

``shard_params`` keeps each rank's shard in place of the tensor (the
parameter objects stay, so take the optimizer after it); ``shard_batch``
gives each rank its data index's rows. ``full_tensor`` / ``local_shard``
move between a shard and the whole tensor for checkpoints.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from ullsam_tpu_torch.parallel import distributed as D
from ullsam_tpu_torch.parallel.distributed import Mesh

Spec = Tuple[Optional[str], ...]
_LLM = r"fusion\.language_model\."
_VIT = r"fusion\.vision_model\.blocks\.\d+\."

# (name regex, spec over the torch tensor's dimensions); first match wins,
# the default replicated
PARAM_RULES: List[Tuple[str, Spec]] = [
    # InternLM2: Megatron, column-parallel in, row-parallel out
    (_LLM + r"model\.layers\.\d+\.attention\.wqkv\.weight", ("model", None)),
    (_LLM + r"model\.layers\.\d+\.attention\.wqkv\.bias", ("model",)),
    (_LLM + r"model\.layers\.\d+\.attention\.wo\.weight", (None, "model")),
    (_LLM + r"model\.layers\.\d+\.feed_forward\.w[13]\.weight",
     ("model", None)),
    (_LLM + r"model\.layers\.\d+\.feed_forward\.w2\.weight",
     (None, "model")),
    (_LLM + r"model\.tok_embeddings\.weight", ("model", None)),
    (_LLM + r"output\.weight", ("model", None)),
    # SAM ViT blocks
    (_VIT + r"attn\.qkv\.weight", ("model", None)),
    (_VIT + r"attn\.qkv\.bias", ("model",)),
    (_VIT + r"attn\.proj\.weight", (None, "model")),
    (_VIT + r"mlp\.lin1\.weight", ("model", None)),
    (_VIT + r"mlp\.lin1\.bias", ("model",)),
    (_VIT + r"mlp\.lin2\.weight", (None, "model")),
    # fusion projectors (Sequential indices: 1 = fc1, 3 = fc2)
    (r"fusion\.mlp[12]\.1\.weight", ("model", None)),
    (r"fusion\.mlp[12]\.1\.bias", ("model",)),
    (r"fusion\.mlp[12]\.3\.weight", (None, "model")),
]

# modules that run Megatron tensor parallelism on their own shards:
# (module name regex, column-parallel linears, row-parallel linears)
MEGATRON: List[Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = [
    (_LLM + r"model\.layers\.\d+",
     ("attention.wqkv", "feed_forward.w1", "feed_forward.w3"),
     ("attention.wo", "feed_forward.w2")),
    (r"fusion\.mlp[12]", ("1",), ("3",)),
]


def create_mesh(dp: int, tp: int = 1) -> Mesh:
    """The ("data", "model") mesh over the ``dp * tp`` ranks of the
    default process group (one process without a group). Raises when the
    world size is not ``dp * tp``. Every rank calls it, in the same order
    as any other group it makes."""
    world = D.process_count()
    if dp < 1 or tp < 1 or world != dp * tp:
        raise ValueError(f"need {dp * tp} processes for dp={dp} x tp={tp}, "
                         f"have {world}")
    rank = D.process_index()
    if not torch.distributed.is_initialized():
        return Mesh(dp, tp, rank)
    data_group = model_group = None
    for m in range(tp):               # one data group per model index
        g = torch.distributed.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data_group = g
    for d in range(dp):               # one model group per data index
        g = torch.distributed.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model_group = g
    return Mesh(dp, tp, rank, data_group, model_group,
                torch.distributed.get_backend())


def param_spec(name: str) -> Spec:
    for pattern, spec in PARAM_RULES:
        if re.fullmatch(pattern, name):
            return spec
    return ()


def _fit_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop sharded axes whose dimension the mesh axis does not divide
    (replicate those dimensions instead)."""
    out = []
    for i, axis in enumerate(spec):
        if axis is not None and i < len(shape) and \
                shape[i] % mesh.shape[axis] == 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


def _model_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _tensors(module: torch.nn.Module):
    """(leaf name, tensor) of a module's own parameters and buffers."""
    for leaf, t in list(module._parameters.items()) + \
            list(module._buffers.items()):
        if t is not None:
            yield leaf, t


def _rule_spec(name: str) -> Spec:
    """The rule of a tensor name; a ``QuantLinear``'s int8 ``qweight``
    takes the weight's, and its per-output-channel ``qscale`` the weight's
    output dimension."""
    base, leaf = name.rpartition(".")[::2]
    if leaf == "qweight":
        return param_spec(f"{base}.weight")
    if leaf == "qscale":
        return param_spec(f"{base}.weight")[:1]
    return param_spec(name)


def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    size = t.shape[dim] // mesh.tp
    return t.detach().narrow(dim, mesh.model_index * size, size).clone(
        memory_format=torch.contiguous_format)


def _plan(module: torch.nn.Module, mesh: Mesh, prefix: str
          ) -> Tuple[Dict[str, Tuple[int, str]], List[torch.nn.Module]]:
    """({full tensor name: (sharded dim, "split" | "gather")}, the modules
    that run Megatron on their shards). Only parameters are gathered, so a
    buffer (an int8 weight) is sharded only where it is split."""
    names = dict(module.named_modules())
    plan: Dict[str, Tuple[int, str]] = {}
    buffers = set()
    for mname, mod in names.items():
        for leaf, t in _tensors(mod):
            if is_sharded(t):   # sharded before: left as it is
                continue
            full = f"{prefix}{mname}.{leaf}" if mname else prefix + leaf
            dim = _model_dim(_fit_spec(_rule_spec(full), t.shape, mesh))
            if dim is not None:
                plan[full] = (dim, "gather")
                if not isinstance(t, torch.nn.Parameter):
                    buffers.add(full)
    megatron = []
    for mname, mod in names.items():
        for pattern, cols, rows in MEGATRON:
            if not re.fullmatch(pattern, prefix + mname):
                continue
            heads = [f"{prefix}{mname}.{lin}." for lin in cols + rows]
            keys = [k for k in plan if k.startswith(tuple(heads))]
            n_weights = sum(k.endswith(("weight", "qweight")) for k in keys)
            if n_weights == len(heads):
                for k in keys:
                    plan[k] = (plan[k][0], "split")
                megatron.append(mod)
            elif getattr(mod, "tp", None) is None:
                # not every weight divides: the module stays whole
                for k in keys:
                    del plan[k]
    for k in buffers:
        if k in plan and plan[k][1] == "gather":
            del plan[k]
    return plan, megatron


def shard_params(module: torch.nn.Module, mesh: Mesh,
                 prefix: str = "") -> torch.nn.Module:
    """Keep each rank's shard of every tensor that a rule shards (in
    place: parameters keep their objects; marked ``tp_split`` or
    ``tp_gather`` = (dim, mesh)), set ``module.mesh``, and mark each
    module that gathers its own weights (``tp_gathered``). ``prefix`` is
    the module's name inside a ``ULLSAM`` (``"fusion.language_model."``
    for an LLM alone). The LLM needs ``num_key_value_heads % tp == 0``. At
    tp 1 nothing is sliced; a tensor sharded before is left as it is.
    Returns ``module``."""
    module.mesh = mesh
    if mesh.tp == 1:
        return module
    llm_cfg = getattr(module, "cfg", None)
    llm_cfg = getattr(llm_cfg, "llm", llm_cfg)
    nkv = getattr(llm_cfg, "num_key_value_heads", None)
    if nkv is not None and nkv % mesh.tp:
        raise ValueError(f"tp={mesh.tp} must divide num_key_value_heads="
                         f"{nkv}: wqkv splits by kv groups")
    plan, megatron = _plan(module, mesh, prefix)
    for mod in megatron:
        mod.tp = mesh
    for mname, mod in module.named_modules():
        gather = False
        for leaf, t in _tensors(mod):
            full = f"{prefix}{mname}.{leaf}" if mname else prefix + leaf
            if full not in plan:
                continue
            dim, mode = plan[full]
            shard = _slice(t, dim, mesh)
            if isinstance(t, torch.nn.Parameter):
                t.data = shard
                shard = t
            else:
                mod._buffers[leaf] = shard
                mod._kernel_checked = False   # QuantLinear: check again
            setattr(shard, "tp_" + mode, (dim, mesh))
            gather |= mode == "gather"
        if gather:
            D.gather_on_call(mod)
    for mod in module.modules():
        if hasattr(type(mod), "tp_gathered"):   # gathers its weights itself
            mod.tp_gathered = any(hasattr(p, "tp_gather")
                                  for p in mod.parameters())
    return module


def is_sharded(t: torch.Tensor) -> bool:
    return hasattr(t, "tp_split") or hasattr(t, "tp_gather")


def _shard_info(t: torch.Tensor):
    return getattr(t, "tp_split", None) or getattr(t, "tp_gather", None)


def full_tensor(t: torch.Tensor, like: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The whole tensor of a shard (``like``: the parameter whose sharding
    ``t``, an optimizer moment say, follows); every model rank calls it."""
    info = _shard_info(like if like is not None else t)
    if info is None:
        return t.detach()
    dim, mesh = info
    return D.all_gather(t.detach(), dim, mesh)


def local_shard(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full``, as ``like`` is sharded."""
    info = _shard_info(like)
    if info is None:
        return full
    dim, mesh = info
    return _slice(full, dim, mesh)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch: the data index's contiguous
    block of the leading dimension (JAX's ``NamedSharding(P("data"))``),
    the same rows on every rank of a model group."""
    def rows(x):
        if x is None:
            return None
        n = x.shape[0]
        if n % mesh.dp:
            raise ValueError(f"batch of {n} rows over dp={mesh.dp}")
        k = n // mesh.dp
        return x[mesh.data_index * k:(mesh.data_index + 1) * k]
    return {k: rows(v) for k, v in batch.items()}


def sync_grads(grads: List[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Replace each gradient, in place, by its mean over the data group:
    one all-reduce per dtype over the flattened gradients."""
    group = None if mesh is None else mesh.data_group
    if group is None or not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        D.all_reduce_(flat, group)
        if mesh.dp > 1:
            flat.div_(mesh.dp)
        off = 0
        for g in gs:
            n = g.numel()
            g.copy_(flat[off:off + n].view_as(g))
            off += n


def mean_over_data(values: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                   ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the data group (one all-reduce)."""
    group = None if mesh is None else mesh.data_group
    if group is None or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    D.all_reduce_(flat, group)
    flat = flat / mesh.dp
    return {k: flat[i] for i, k in enumerate(keys)}
