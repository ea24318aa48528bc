"""Autoregressive generation over the fixed-shape KV cache
(``ullsam_tpu/models/internlm2/generate.py:28-65,129-189``) and the serving
engine's per-row sampling (``:68-126``).

The JAX package runs prefill and an on-device ``while_loop``; here a host
loop under ``torch.inference_mode()`` runs one decode step a token and stops
once every row has produced EOS (reading the done flags back each step).
Logit warpers (temperature -> top-k -> top-p) follow HF semantics; sampling
draws from an explicit ``torch.Generator`` in place of the JAX key, so its
draws differ from JAX's for the same seed (greedy decoding is identical).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ullsam_tpu_torch.core.config import InternLM2Config
from ullsam_tpu_torch.models.internlm2.model import (
    InternLM2ForCausalLM, embed_tokens, init_cache, internlm2_decode_step,
    internlm2_prefill)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    eos_token_id: int = 2
    pad_token_id: int = 2


def apply_warpers(logits: Tensor, gen: GenerationConfig) -> Tensor:
    """temperature -> top-k -> top-p, HF ordering; logits [B, V] -> f32
    with the dropped tokens at -inf."""
    logits = logits.float()
    if gen.temperature != 1.0:
        logits = logits / gen.temperature
    if gen.top_k > 0:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if gen.top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        probs = torch.softmax(logits.gather(-1, order), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < gen.top_p  # always keeps the top token
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def sample_token(logits: Tensor, gen: GenerationConfig,
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """[B, V] -> [B] token ids: argmax, or a draw from the warped
    distribution with ``generator``."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(apply_warpers(logits, gen), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass
class SamplingParams:
    """Per-row sampling knobs as [B] tensors, so one decode step serves
    requests with different generation configs (the reference takes
    temperature / top_p / top_k / do_sample per caption call,
    app.py:443-459)."""
    temperature: Tensor  # [B] f32
    top_k: Tensor        # [B] int64; 0 = disabled
    top_p: Tensor        # [B] f32; 1.0 = disabled
    do_sample: Tensor    # [B] bool

    FIELDS = ("temperature", "top_k", "top_p", "do_sample")

    @staticmethod
    def from_configs(gens: Sequence[Optional[GenerationConfig]],
                     pad_to: Optional[int] = None,
                     device=None) -> "SamplingParams":
        """From a list of GenerationConfig (None rows, and rows up to
        ``pad_to``, greedy), on ``device`` (default the CPU)."""
        n = pad_to or len(gens)
        t, k, p, s = [1.0] * n, [0] * n, [1.0] * n, [False] * n
        for i, g in enumerate(gens):
            if g is not None:
                t[i], k[i], p[i], s[i] = (g.temperature, g.top_k, g.top_p,
                                          g.do_sample)
        return SamplingParams(
            torch.tensor(t, dtype=torch.float32, device=device),
            torch.tensor(k, dtype=torch.int64, device=device),
            torch.tensor(p, dtype=torch.float32, device=device),
            torch.tensor(s, dtype=torch.bool, device=device))

    def map(self, fn: Callable[[Tensor], Tensor]) -> "SamplingParams":
        """``fn`` applied to each of the four tensors."""
        return SamplingParams(*(fn(getattr(self, n)) for n in self.FIELDS))


def _dynamic_threshold(logits: Tensor, samp: SamplingParams):
    """temperature -> top-k -> top-p with per-row knobs over one
    descending sort: (l, sorted values, their vocab order, threshold), the
    warped distribution keeping exactly the tokens with l >= threshold."""
    logits = logits.float()
    V = logits.shape[-1]
    l = logits / samp.temperature.clamp_min(1e-6)[:, None]
    vals, order = torch.sort(l, dim=-1, descending=True)
    # top-k: keep values >= the k-th largest (k = 0 disables)
    k = torch.where(samp.top_k > 0, samp.top_k, V)
    kth = vals.gather(1, (k - 1).clamp(0, V - 1)[:, None])
    # top-p on the post-top-k distribution: the nucleus is a prefix of the
    # sort; threshold at its last value
    in_k = torch.arange(V, device=l.device)[None, :] < k[:, None]
    masked = vals.masked_fill(~in_k, float("-inf"))
    probs = torch.softmax(masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < samp.top_p[:, None]   # the top token always kept
    n_keep = keep.sum(dim=-1).clamp_min(1)
    pth = masked.gather(1, (n_keep - 1)[:, None])
    return l, vals, order, torch.maximum(kth, pth)


def warp_dynamic(logits: Tensor, samp: SamplingParams) -> Tensor:
    """The per-row warped logits [B, V] f32 that ``sample_token_dynamic``
    draws from, dropped tokens at -inf (HF warper semantics)."""
    l, _, _, thr = _dynamic_threshold(logits, samp)
    return l.masked_fill(l < thr, float("-inf"))


def sample_token_dynamic(logits: Tensor, samp: SamplingParams,
                         generator: Optional[torch.Generator] = None,
                         uniform: Optional[Tensor] = None) -> Tensor:
    """[B, V] -> [B] int64 with PER-ROW temperature / top-k / top-p /
    do_sample (``generate.py:94-126``): greedy rows take the argmax, sampled
    rows invert the CDF of the warped distribution over the one descending
    sort at a uniform draw, ``uniform`` [B] or else drawn from
    ``generator``. No host sync and no multinomial, so a captured decode
    step takes its draws from a buffer the host refills between replays."""
    greedy = torch.argmax(logits, dim=-1)
    _, vals, order, thr = _dynamic_threshold(logits, samp)
    p = torch.softmax(vals.masked_fill(vals < thr, float("-inf")), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    if uniform is None:
        uniform = torch.rand(logits.shape[0], generator=generator,
                             device=logits.device)
    target = (uniform * cdf[:, -1])[:, None].contiguous()
    idx = torch.searchsorted(cdf, target, right=True).clamp_max(
        logits.shape[-1] - 1)
    sampled = order.gather(1, idx)[:, 0]
    return torch.where(samp.do_sample, sampled, greedy)


def last_valid_index(attention_mask: Tensor) -> Tensor:
    """Index of the last 1 in each row of a [B, S] mask."""
    S = attention_mask.shape[-1]
    return S - 1 - torch.argmax(attention_mask.flip(-1).int(), dim=-1)


@torch.inference_mode()
def generate(lm: InternLM2ForCausalLM, cfg: InternLM2Config,
             gen: GenerationConfig, inputs_embeds: Tensor,
             attention_mask: Tensor,
             generator: Optional[torch.Generator] = None,
             step_hook: Optional[Callable[[int, Tensor], None]] = None,
             cache_dtype: Optional[torch.dtype] = None
             ) -> Tuple[Tensor, Tensor]:
    """Up to ``gen.max_new_tokens`` continuation tokens.

    inputs_embeds [B, S, H] (image embeddings already scattered in);
    attention_mask [B, S]. The cache holds S + max_new_tokens slots, in
    ``cache_dtype`` (default inputs_embeds' dtype; the serving engine keeps
    bf16 under an f32 model).
    Returns (tokens [B, max_new_tokens] int32, pad_token_id after each
    row's EOS; lengths [B] int32, through the first EOS or max_new_tokens).
    ``step_hook(i, logits)``, when given, is called once token i has been
    chosen from ``logits`` [B, V] and the done flags read back (so all work
    of that step has finished): i = 0 after the prefill, then once per
    decode step."""
    B, S, _ = inputs_embeds.shape
    T = gen.max_new_tokens
    dev = inputs_embeds.device
    cache = init_cache(cfg, B, S + T, dtype=cache_dtype or inputs_embeds.dtype,
                       device=dev)
    mask = attention_mask.to(device=dev, dtype=torch.int32)
    out, cache = internlm2_prefill(lm, cfg, inputs_embeds, mask, cache)
    rows = torch.arange(B, device=dev)
    logits = out["logits"][rows, last_valid_index(mask)]
    del out
    tok = sample_token(logits, gen, generator).int()
    done = tok == gen.eos_token_id
    buf = torch.full((B, T), gen.pad_token_id, dtype=torch.int32, device=dev)
    buf[:, 0] = tok
    step = 0
    while True:
        finished = bool(done.all())
        if step_hook is not None:
            step_hook(step, logits)
        step += 1
        if finished or step >= T:
            break
        emb = embed_tokens(lm, tok)[:, None, :].to(inputs_embeds.dtype)
        logits, cache = internlm2_decode_step(lm, cfg, emb, cache)
        nxt = sample_token(logits, gen, generator).int()
        tok = torch.where(done, gen.pad_token_id, nxt).int()
        buf[:, step] = tok
        done = done | (tok == gen.eos_token_id)
    is_eos = buf == gen.eos_token_id
    lengths = torch.where(is_eos.any(-1), torch.argmax(is_eos.int(), -1) + 1,
                          T).int()
    return buf, lengths


# ---------------------------------------------------------------------------
# beam search (``generate.py:202-296``; the reference gets it through HF
# generate and _reorder_cache, modeling_internlm2.py:1151-1158)
# ---------------------------------------------------------------------------


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest of a 1-D tensor, descending, ties (``-inf`` among
    them) in index order as ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


@torch.inference_mode()
def beam_search(lm: InternLM2ForCausalLM, cfg: InternLM2Config,
                inputs_embeds: Tensor, attention_mask: Tensor,
                num_beams: int = 4, max_new_tokens: int = 64,
                eos_token_id: int = 2, pad_token_id: int = 2,
                length_penalty: float = 1.0,
                max_len: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Beam search for ONE prompt (inputs_embeds [1, S, H], attention_mask
    [1, S]), ``num_beams`` explored, in the model's dtype (bf16, f32, or
    int8 linears through B12).

    The prompt prefills once and its cache is repeated across the beams;
    each step scores every (beam, token), keeps the best eos candidate in a
    finished pool of ``num_beams`` (length-penalized by (t + 2) **
    ``length_penalty``) and the best ``num_beams`` others alive, and
    reorders the cache rows by parent in place (``index_select`` along the
    batch of k, v and mask; ``index`` is shared). The loop runs all
    ``max_new_tokens - 1`` steps, as JAX's fixed-shape scan does, with no
    host sync. Returns (tokens [max_new_tokens] int32, score []): the best
    finished or (penalized by max_new_tokens ** ``length_penalty``) alive
    hypothesis, eos included and pad after."""
    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("beam_search explores the beams of one prompt")
    K, T = num_beams, max_new_tokens
    dev = inputs_embeds.device
    if max_len is None:
        max_len = S + T
    ninf = float("-inf")
    cache = init_cache(cfg, 1, max_len, dtype=inputs_embeds.dtype,
                       device=dev)
    mask = attention_mask.to(device=dev, dtype=torch.int32)
    out, cache = internlm2_prefill(lm, cfg, inputs_embeds, mask, cache)
    logp0 = torch.log_softmax(
        out["logits"][0, last_valid_index(mask)[0]].float(), dim=-1)
    del out
    cache.k = cache.k.repeat_interleave(K, dim=1)
    cache.v = cache.v.repeat_interleave(K, dim=1)
    cache.mask = cache.mask.repeat_interleave(K, dim=0)

    scores, tok = _top_k(logp0, K)
    tok = tok.int()
    buf = torch.full((K, T), pad_token_id, dtype=torch.int32, device=dev)
    buf[:, 0] = tok
    # beams that start with eos finish at once
    is_eos0 = tok == eos_token_id
    fin_scores = torch.where(is_eos0, scores / (1.0 ** length_penalty),
                             ninf)
    fin_buf = torch.where(is_eos0[:, None], buf, pad_token_id)
    scores = scores.masked_fill(is_eos0, ninf)
    eos_id = torch.tensor(eos_token_id, dtype=torch.int32, device=dev)

    for t in range(T - 1):
        emb = embed_tokens(lm, tok)[:, None, :].to(inputs_embeds.dtype)
        logits, cache = internlm2_decode_step(lm, cfg, emb, cache)
        logp = torch.log_softmax(logits.float(), dim=-1)
        total = scores[:, None] + logp                         # [K, V]
        V = total.shape[-1]
        cand_scores, cand_idx = _top_k(total.reshape(-1), 2 * K)
        cand_beam = cand_idx // V
        cand_tok = (cand_idx % V).int()
        cand_eos = cand_tok == eos_token_id

        # finished pool: the best eos candidate replaces the worst entry
        lp_den = float(t + 2) ** length_penalty
        eos_scores = torch.where(cand_eos, cand_scores, ninf) / lp_den
        best_eos = torch.argmax(eos_scores)
        worst_fin = torch.argmin(fin_scores)
        take = eos_scores[best_eos] > fin_scores[worst_fin]
        new_row = buf[cand_beam[best_eos]].clone()
        new_row[t + 1] = eos_id
        slot = torch.arange(K, device=dev) == worst_fin
        fin_scores = torch.where(take & slot, eos_scores[best_eos],
                                 fin_scores)
        fin_buf = torch.where((take & slot)[:, None], new_row[None], fin_buf)

        # alive beams: the best K non-eos candidates; the cache follows its
        # parents in place (the _reorder_cache analog)
        keep_scores, keep = _top_k(cand_scores.masked_fill(cand_eos, ninf),
                                   K)
        parent = cand_beam[keep]
        tok = cand_tok[keep]
        cache.k.copy_(cache.k.index_select(1, parent))
        cache.v.copy_(cache.v.index_select(1, parent))
        cache.mask.copy_(cache.mask.index_select(0, parent))
        buf = buf.index_select(0, parent)
        buf[:, t + 1] = tok
        scores = keep_scores

    alive = scores / (float(T) ** length_penalty)
    all_scores = torch.cat([fin_scores, alive])
    best = torch.argmax(all_scores)
    return torch.cat([fin_buf, buf])[best], all_scores[best]
