"""InternLM2 decoder-only LLM (``ullsam_tpu/models/internlm2/model.py``):
the full-sequence forward without a cache (``:75-353``), the KV-cache
prefill / decode steps (``:142-154,361-528``) and the serving steps
(``:421-469,625-715``): a prompt segment at a cache offset and the
continuous-batching decode step with per-row write positions.

RMSNorm in f32, RoPE with linear / dynamic-NTK scaling, GQA through the
fused ``wqkv`` packing without ``repeat_kv``, SwiGLU, f32 softmax, untied
output head. Layers are a ``ModuleList``.

Attention takes one of two routes, as the JAX package dispatches them
(``model.py:315-335``):
* below ``LLM_FLASH_MIN`` tokens, plain matmul + softmax: causality is a
  boolean [S, T] compare, key padding a [B, 1, T] additive term and packed
  segments a [B, S, T] equality, so no [S, T] f32 mask is ever built;
* from ``LLM_FLASH_MIN`` on, the flash kernel B10
  (``ops/kernels/llm_flash_attention.py``; its gradient is B11) with the
  segment ids, or the padding mask, as both query and key segments.
The two differ only on padding rows (id 0): the flash route lets them
attend each other, the plain route gives their keys -1e9. Valid rows, the
loss and every gradient agree.

``segment_ids`` [B, S] (0 = padding) is the packed-rows mode: several
documents share one row, tokens attend only within their own segment and
RoPE positions restart at each segment.

Layouts: activations [B, S, H]; q/k/v [B, S, heads, head_dim].

Tensor parallelism (``parallel/partitioning.py`` ``shard_params``): a
layer whose ``tp`` is a mesh holds its model index's share of ``wqkv``,
``w1`` and ``w3`` (output rows: whole kv groups, so its own q, k and v
heads) and of ``wo`` and ``w2`` (input columns). It runs attention on its
heads alone, reads head counts from the tensors (never from the config),
and sums the ``wo`` and ``w2`` products over the model group. The KV cache
then holds the rank's kv heads (``init_cache(kv_heads=)``,
``local_kv_heads``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ullsam_tpu_torch.core.config import InternLM2Config
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels.llm_flash_attention import (
    llm_flash_attention)
from ullsam_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from ullsam_tpu_torch.parallel.distributed import (copy_to_model,
                                                   row_parallel_linear)

Tensor = torch.Tensor

NEG_INF = -1e9  # additive mask value (f32 logits)
LLM_FLASH_MIN = 2048  # sequence length from which attention runs B10


class Attention(nn.Module):
    def __init__(self, cfg: InternLM2Config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        H = cfg.hidden_size
        qkv_out = (cfg.num_attention_heads
                   + 2 * cfg.num_key_value_heads) * cfg.head_dim
        self.wqkv = L.Linear(H, qkv_out, bias=cfg.bias, **kw)
        self.wo = L.Linear(H, H, bias=cfg.bias, **kw)


class FeedForward(nn.Module):
    def __init__(self, cfg: InternLM2Config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.w1 = L.Linear(H, I, bias=False, **kw)
        self.w3 = L.Linear(H, I, bias=False, **kw)
        self.w2 = L.Linear(I, H, bias=False, **kw)

    def forward(self, x: Tensor, tp=None) -> Tensor:
        """w2(silu(w1 x) * w3 x), the silu in f32 (``layers.py:320-327``);
        each projection a ``Linear`` or a ``QuantLinear``; under a mesh
        ``tp`` w1 / w3 hold this rank's hidden units and the w2 product is
        summed over the model group."""
        x = copy_to_model(x, tp)
        h = F.silu(self.w1(x).float()).to(x.dtype) * self.w3(x)
        return row_parallel_linear(self.w2, h, tp)


class DecoderLayer(nn.Module):
    tp = None  # the mesh when its linears are sharded (shard_params)

    def __init__(self, cfg: InternLM2Config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                        **kw)
        self.attention = Attention(cfg, **kw)
        self.ffn_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.feed_forward = FeedForward(cfg, **kw)
        self.cfg = cfg

    def forward(self, x: Tensor, cos: Tensor, sin: Tensor,
                kmask: Optional[Tensor], seg: Optional[Tensor] = None,
                flash: bool = False,
                cache: Optional[tuple] = None) -> Tensor:
        """``flash``: attention through B10 with ``seg`` [B, S] int32 as
        both segment ids (``kmask`` unused); else the plain route, with
        ``seg`` (packed rows) or None. ``cache`` = (k_cache, v_cache, slot,
        W): the layer against a KV cache (``_layer_body`` with ``k_cache``,
        ``model.py:194-206``): the new k / v [B, S, n_kv, hd] are written in
        place into k_cache / v_cache [B, max_len, n_kv, hd] (cast to the
        cache dtype) at slots [slot, slot + S) for an int ``slot``, or, one
        token a row, at slot[b] of row b for a [B] tensor ``slot``; then
        plain attention runs over slots [0, W), that window alone cast back
        to q's dtype, under ``kmask`` [B, S | 1, W], which carries
        causality."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = self.attention_norm(x)
        q, k, v = split_wqkv(self.attention.wqkv(copy_to_model(h, self.tp)),
                             cfg)
        q, k = apply_rope(q, k, cos, sin)
        if cache is not None:
            k_cache, v_cache, slot, W = cache
            if isinstance(slot, int):
                k_cache[:, slot:slot + S] = k
                v_cache[:, slot:slot + S] = v
            else:
                rows = torch.arange(B, device=x.device)
                k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
                v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
            attn = gqa_attention(q, k_cache[:, :W].to(q.dtype),
                                 v_cache[:, :W].to(q.dtype), kmask, cfg)
        elif flash:
            attn = llm_flash_attention(q, k, v, seg, seg, k.shape[2],
                                       causal=True)
        else:
            attn = gqa_attention(q, k, v, kmask, cfg, causal=True,
                                 seg=None if seg is None else (seg, seg))
        x = x + row_parallel_linear(self.attention.wo,
                                    attn.reshape(B, S, -1), self.tp)
        return x + self.feed_forward(self.ffn_norm(x), self.tp)


class InternLM2Model(nn.Module):
    def __init__(self, cfg: InternLM2Config, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.tok_embeddings = L.Embedding(cfg.vocab_size, cfg.hidden_size,
                                          std=0.02, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)


class InternLM2ForCausalLM(nn.Module):
    """``model.{tok_embeddings, layers.{i}, norm}`` and ``output``, the
    reference checkpoint names; on the GPU unless ``device`` says
    otherwise."""

    def __init__(self, cfg: InternLM2Config, *, device="cuda", dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.model = InternLM2Model(cfg, device=device, dtype=dtype)
        self.output = L.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                               device=device, dtype=dtype)


def embed_tokens(lm: InternLM2ForCausalLM, input_ids: Tensor) -> Tensor:
    return lm.model.tok_embeddings(input_ids)


def split_wqkv(qkv: Tensor, cfg: InternLM2Config):
    """Unpack the fused wqkv output: [B, S, n_kv, groups + 2, hd] with the
    q groups first, then k, then v (n_kv: the kv heads the output holds,
    all of them or a tensor-parallel rank's)."""
    B, S, _ = qkv.shape
    g = cfg.num_kv_groups
    qkv = qkv.reshape(B, S, -1, g + 2, cfg.head_dim)
    q = qkv[:, :, :, :g, :].reshape(B, S, -1, cfg.head_dim)
    return q, qkv[:, :, :, -2, :], qkv[:, :, :, -1, :]


def gqa_attention(q: Tensor, k: Tensor, v: Tensor, kmask: Optional[Tensor],
                  cfg: InternLM2Config, *, causal: bool = False,
                  seg: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Grouped-query attention without repeat_kv.

    q [B, S, nh, hd]; k, v [B, T, n_kv, hd]; kmask additive [B, 1, T] (one
    row for every query) or [B, S, T] (a row per query, the cache steps'
    causal-and-padding mask), or None; causal applies q_pos >= kv_pos
    (S == T); seg = (seg_q [B, S],
    seg_k [B, T]) confines attention to equal packed segments. Logits and
    softmax in f32; probabilities cast to v.dtype. Returns [B, S, nh, hd]."""
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, nkv, g * S, hd).float()
    kt = k.permute(0, 2, 3, 1).float()                  # [B, nkv, hd, T]
    logits = torch.matmul(qg, kt) * hd ** -0.5          # [B, nkv, g*S, T]
    logits = logits.reshape(B, nkv, g, S, T)
    if kmask is not None:
        logits = logits + kmask.reshape(B, 1, 1, kmask.shape[-2], T)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, NEG_INF)
    if seg is not None:
        same = seg[0][:, :, None] == seg[1][:, None, :]      # [B, S, T]
        logits = logits.masked_fill(~same[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.reshape(B, nkv, g * S, T),
                       v.permute(0, 2, 1, 3))           # [B, nkv, g*S, hd]
    out = out.reshape(B, nkv, g, S, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, nh, hd).to(q.dtype)


def segment_positions(segment_ids: Tensor) -> Tensor:
    """RoPE positions that restart at each packed segment: index - (index
    of its segment's first token), 0 on padding (id 0)."""
    B, S = segment_ids.shape
    same = segment_ids[:, 1:] == segment_ids[:, :-1]
    run = torch.cat([torch.zeros_like(same[:, :1]), same], dim=-1).long()
    idx = torch.arange(S, device=segment_ids.device)[None]
    start = torch.cummax(idx * (1 - run), dim=-1).values
    return (idx - start) * (segment_ids != 0).long()


def internlm2_forward(lm: InternLM2ForCausalLM, cfg: InternLM2Config,
                      input_ids: Optional[Tensor] = None,
                      inputs_embeds: Optional[Tensor] = None,
                      attention_mask: Optional[Tensor] = None,
                      position_ids: Optional[Tensor] = None,
                      segment_ids: Optional[Tensor] = None,
                      output_hidden_states: bool = False,
                      remat: bool = False) -> dict:
    """Full-sequence forward -> {'logits' [B, S, V], 'last_hidden' [B, S, H]
    (post final norm), and with output_hidden_states 'hidden_states'
    [L, B, S, H], the input of each layer}. Differentiable in the
    activations whether or not the weights are frozen; ``remat`` checkpoints
    each layer (``torch.utils.checkpoint``; under it the flash route runs B10
    again in the backward). ``segment_ids`` [B, S] (0 = padding) packs
    several documents into a row: it replaces ``attention_mask`` by
    ``segment_ids != 0`` and, unless ``position_ids`` are given, restarts
    the positions at each segment."""
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(
        lm, input_ids)
    B, S, _ = x.shape
    if segment_ids is not None:
        attention_mask = (segment_ids != 0).int()
        if position_ids is None:
            position_ids = segment_positions(segment_ids)
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32,
                                    device=x.device)
    if position_ids is None:
        # position = cumsum of the padding mask - 1, clamped at 0
        position_ids = (torch.cumsum(attention_mask, dim=-1) - 1).clamp_min(0)
    cos, sin = rope_cos_sin(cfg, position_ids, ntk_seq_len=S)
    flash = S >= LLM_FLASH_MIN
    seg = (segment_ids if segment_ids is not None else attention_mask)
    seg = seg.to(torch.int32).contiguous()
    kmask = None
    if not flash:
        kmask = torch.where(attention_mask.bool(), 0.0,
                            NEG_INF).float()[:, None]
        if segment_ids is None:
            seg = None
    hidden = []
    for layer in lm.model.layers:
        if output_hidden_states:
            hidden.append(x)
        if remat:
            x = checkpoint(layer, x, cos, sin, kmask, seg, flash,
                           use_reentrant=False)
        else:
            x = layer(x, cos, sin, kmask, seg, flash)
    last_hidden = lm.model.norm(x)
    out = {"logits": lm.output(last_hidden), "last_hidden": last_hidden}
    if output_hidden_states:
        out["hidden_states"] = torch.stack(hidden)
    return out


# ---------------------------------------------------------------------------
# KV-cache prefill / decode (``model.py:142-154,361-528``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """The fixed-shape cache, preallocated once and written in place by
    ``internlm2_prefill`` / ``internlm2_decode_step`` (the JAX package
    returns a new cache each step)."""
    k: Tensor      # [L, B, max_len, n_kv, hd]
    v: Tensor      # [L, B, max_len, n_kv, hd]
    mask: Tensor   # [B, max_len] int32 validity of the cache slots
    index: int     # next write slot


def local_kv_heads(lm: InternLM2ForCausalLM) -> int:
    """The kv heads that this rank's layers compute: all of them, or a
    tensor-parallel share."""
    cfg, layer = lm.cfg, lm.model.layers[0]
    tp = 1 if layer.tp is None else layer.tp.tp
    return cfg.num_key_value_heads // tp


def init_cache(cfg: InternLM2Config, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None, kv_heads: Optional[int] = None) -> KVCache:
    """A zeroed cache; ``kv_heads`` (default all) of a tensor-parallel
    rank's share (``local_kv_heads``)."""
    shape = (cfg.num_hidden_layers, batch, max_len,
             kv_heads or cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   mask=torch.zeros((batch, max_len), dtype=torch.int32,
                                    device=device),
                   index=0)


def causal_mask(attention_mask: Tensor, q_len: int, kv_len: int) -> Tensor:
    """Additive [B, q_len, kv_len] f32 mask of causality and padding, the
    queries at positions [0, q_len): attention_mask [B, kv_len] validity."""
    dev = attention_mask.device
    q_pos = torch.arange(q_len, device=dev)[:, None]
    kv_pos = torch.arange(kv_len, device=dev)[None, :]
    ok = (q_pos >= kv_pos)[None] & attention_mask[:, None, :].bool()
    return torch.where(ok, 0.0, NEG_INF).float()


def internlm2_prefill(lm: InternLM2ForCausalLM, cfg: InternLM2Config,
                      inputs_embeds: Tensor, attention_mask: Tensor,
                      cache: KVCache) -> Tuple[dict, KVCache]:
    """Prefill the cache with a [B, S, H] prompt (S <= max_len), left or
    right padded (attention_mask [B, S]): k / v go into slots [0, S) in
    place, the cache mask becomes the prompt's, ``index`` S. Positions are
    cumsum(mask) - 1 clamped at 0 and the dynamic-NTK length is the cache's
    max_len, as in the decode steps. Attention runs the plain route over
    all max_len slots (never B10, as in JAX). Returns ({'logits' [B, S, V],
    'last_hidden' [B, S, H]}, cache)."""
    x = inputs_embeds
    B, S, _ = x.shape
    max_len = cache.k.shape[2]
    position_ids = (torch.cumsum(attention_mask, dim=-1) - 1).clamp_min(0)
    cos, sin = rope_cos_sin(cfg, position_ids, ntk_seq_len=max_len)
    cache.mask.zero_()
    cache.mask[:, :S] = attention_mask
    mask = causal_mask(cache.mask, S, max_len)
    for i, layer in enumerate(lm.model.layers):
        x = layer(x, cos, sin, mask,
                  cache=(cache.k[i], cache.v[i], 0, max_len))
    cache.index = S
    last_hidden = lm.model.norm(x)
    return {"logits": lm.output(last_hidden),
            "last_hidden": last_hidden}, cache


def internlm2_prefill_at(lm: InternLM2ForCausalLM, cfg: InternLM2Config,
                         inputs_embeds: Tensor, chunk_mask: Tensor,
                         cache: KVCache, start: int,
                         compute_logits: bool = True,
                         logit_rows=None) -> Tuple[dict, KVCache]:
    """Chunked prefill (``model.py:421-469``): a right-packed [B, C, H]
    prompt segment written in place at cache slots [start, start + C),
    attending to everything cached so far plus the causal prefix of the
    segment. chunk_mask [B, C] is the validity inside the segment (only a
    prompt's last segment has a padded tail). Positions are start + i, the
    dynamic-NTK length the cache's max_len. Attention reads slots [0, start
    + C) alone (the JAX step masks the rest of max_len). ``compute_logits``
    False skips the head; ``logit_rows`` (a slice or indices into the
    segment) limits it to the rows a caller reads. Returns ({'last_hidden' [B, C, H],
    'logits' [B, C | len(logit_rows), V] when asked}, cache)."""
    x = inputs_embeds
    B, C, _ = x.shape
    max_len = cache.k.shape[2]
    W = start + C
    dev = x.device
    qpos = start + torch.arange(C, device=dev)
    cos, sin = rope_cos_sin(cfg, qpos[None].expand(B, C),
                            ntk_seq_len=max_len)
    cache.mask[:, start:W] = chunk_mask
    causal = torch.arange(W, device=dev)[None, :] <= qpos[:, None]
    ok = cache.mask[:, None, :W].bool() & causal[None]
    mask = torch.where(ok, 0.0, NEG_INF).float()               # [B, C, W]
    for i, layer in enumerate(lm.model.layers):
        x = layer(x, cos, sin, mask, cache=(cache.k[i], cache.v[i], start, W))
    cache.index = W
    last_hidden = lm.model.norm(x)
    out = {"last_hidden": last_hidden}
    if compute_logits:
        out["logits"] = lm.output(last_hidden if logit_rows is None
                                  else last_hidden[:, logit_rows])
    return out, cache


def internlm2_decode_step(lm: InternLM2ForCausalLM, cfg: InternLM2Config,
                          token_embeds: Tensor, cache: KVCache
                          ) -> Tuple[Tensor, KVCache]:
    """One decode step, token_embeds [B, 1, H] -> (logits [B, V], cache):
    the new token goes into slot ``cache.index`` of every row (in place) at
    position sum(cache.mask) per row (right under left padding), with the
    dynamic-NTK length max_len; attention reads the whole max_len window."""
    max_len = cache.k.shape[2]
    position_ids = cache.mask.sum(dim=-1, keepdim=True)          # [B, 1]
    cos, sin = rope_cos_sin(cfg, position_ids, ntk_seq_len=max_len)
    slot = cache.index
    cache.mask[:, slot] = 1
    # one query at the end of the sequence: no causal row constraint
    mask = torch.where(cache.mask[:, None, :].bool(), 0.0, NEG_INF).float()
    x = token_embeds
    for i, layer in enumerate(lm.model.layers):
        x = layer(x, cos, sin, mask,
                  cache=(cache.k[i], cache.v[i], slot, max_len))
    cache.index = slot + 1
    logits = lm.output(lm.model.norm(x))[:, 0, :]
    return logits, cache


def internlm2_decode_step_multi(lm: InternLM2ForCausalLM,
                                cfg: InternLM2Config, token_embeds: Tensor,
                                cache: KVCache, active: Tensor,
                                attend_len: Optional[int] = None
                                ) -> Tuple[Tensor, KVCache]:
    """Continuous-batching decode step (``model.py:625-715``) with per-row
    write positions: rows are right-packed (tokens at slots [0, len)), and
    row b writes its token at slot len_b = sum(mask[b]), in place, at
    position len_b. Inactive rows (``active`` [B] bool False) write k / v
    there too, as JAX does, but leave their mask alone, so a later
    admission overwrites the slot. Attention reads slots [0, attend_len)
    (every row's length after this step must fit; default all max_len).
    A write past the last slot (a row decoding on past its budget) lands
    in the last slot, where JAX drops it. No host sync: the step can be
    captured in a CUDA graph. Returns (logits [B, V], cache).

    ``_win``, ``gqa_attention_decode_split`` and the ``unroll`` /
    ``split_attn`` switches of the JAX step keep XLA's scan from copying the
    cache; an in-place step makes no such copy, so they are not ported."""
    B = token_embeds.shape[0]
    max_len = cache.k.shape[2]
    W = max_len if attend_len is None else min(attend_len, max_len)
    rows = torch.arange(B, device=token_embeds.device)
    lens = cache.mask.sum(dim=-1)                                 # [B]
    pos = lens.clamp_max(max_len - 1)
    cos, sin = rope_cos_sin(cfg, lens[:, None], ntk_seq_len=max_len)
    cache.mask[rows, pos] = torch.where(active, 1, cache.mask[rows, pos])
    mask = torch.where(cache.mask[:, None, :W].bool(), 0.0, NEG_INF).float()
    x = token_embeds
    for i, layer in enumerate(lm.model.layers):
        x = layer(x, cos, sin, mask, cache=(cache.k[i], cache.v[i], pos, W))
    logits = lm.output(lm.model.norm(x))[:, 0, :]
    return logits, cache
