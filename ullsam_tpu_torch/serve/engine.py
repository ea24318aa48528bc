"""Continuous-batching caption engine (``ullsam_tpu/serve/engine.py``).

Concurrent caption / chat requests share ONE fixed-shape multi-slot KV
cache: each request is prefilled in segments into a one-row cache, spliced
into a free slot (right-packed), and one decode chunk advances every active
slot ``n_steps`` tokens. New requests are admitted between chunks.

On the card each decode chunk is one captured ``torch.cuda.CUDAGraph``,
keyed by ``(n_steps, attend_len, dynamic_sampling)``, the JAX step's static
arguments. The graph reads and writes static buffers (``StepState``: the
tokens, ``active``, the ``SamplingParams``, the cache and a buffer of
uniform draws) that the host refills between replays. Each key is run once
eagerly on a side stream (builds, caches, the launch count of a step), then
captured. A failed capture or replay raises; the engine never falls back to
eager launches on the card. On the CPU the same step body runs eagerly.

All device work, capture included, happens on the engine's worker thread;
request threads only enqueue. The worker keeps up to two chunks in flight:
each chunk's tokens go to a pinned host buffer by a non-blocking copy and a
recorded event, and the worker waits on that event when it consumes the
chunk two loops later.

Tensor parallelism (``mesh=``, the JAX engine's mode, ``engine.py:232-271,
396-431``): every rank of the mesh's model group builds the engine over
the same model; the parameters are sharded by ``parallel/partitioning.py``'s
rules (int8 weights quantized whole, then sharded: a row-parallel shard
keeps the whole per-channel scale, so its partial product is scaled, then
summed) and the KV cache holds the rank's kv heads. The JAX engine has one
controller; here each rank is a process. Rank 0 owns the queue: at the top
of each worker loop it broadcasts what it took from the queue (prompt ids,
pixels, budget, sampling settings) and whether to stop, every rank then
runs the same loop on the same intake, and the uniform draws of sampled
chunks and the first tokens are broadcast from rank 0. Each rank's logits
are the same (an all-reduce gives every rank one sum), so their greedy
tokens, and the host decisions that follow from them, agree. The other
ranks call ``wait()``. A captured CUDA graph can hold NCCL collectives but
not gloo's: under a gloo group (two ranks on one card) the chunks run
eagerly; ``chunk_mode`` says which ("graph" or "eager"; always eager on the
CPU).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ullsam_tpu_torch.core.config import FusionConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.models.internlm2 import model as LLM
from ullsam_tpu_torch.models.internlm2.generate import (GenerationConfig,
                                                        SamplingParams,
                                                        sample_token_dynamic)
from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
from ullsam_tpu_torch.models.ullsam import fusion as F
from ullsam_tpu_torch.models.ullsam.conversation import (build_chat_prompt,
                                                         get_conv_template)
from ullsam_tpu_torch.ops.kernels.int8_matmul import uncounted, w8a16_matmul
from ullsam_tpu_torch.parallel import distributed as D
from ullsam_tpu_torch.parallel.partitioning import shard_params

Tensor = torch.Tensor


def _upload(dst: Tensor, src: Tensor) -> Tensor:
    """Copy host tensor ``src`` into ``dst`` without waiting on the device:
    through pinned memory when ``dst`` is on a card."""
    if dst.device.type == "cuda":
        src = src.pin_memory()
    return dst.copy_(src, non_blocking=True)


def _to_device(x, device: torch.device) -> Tensor:
    """``x`` (numpy or tensor) on ``device``, host data uploaded without
    waiting on the device."""
    x = torch.as_tensor(x)
    if x.device == device:
        return x
    return _upload(torch.empty(x.shape, dtype=x.dtype, device=device),
                   x.cpu())


def _upload_samp(dst: SamplingParams, src: SamplingParams) -> None:
    for name in SamplingParams.FIELDS:
        _upload(getattr(dst, name), getattr(src, name))


def _embed_prompt(model: F.ULLSAM, lm: LLM.InternLM2ForCausalLM,
                  cfg: FusionConfig, input_ids: Tensor,
                  pixel_values: Optional[Tensor]) -> Tensor:
    """Prompt token embeddings with the image features scattered in
    (``engine.py:57-69``). uint8 pixels are converted on the device."""
    embeds = LLM.embed_tokens(lm, input_ids)
    if pixel_values is not None:
        if pixel_values.dtype == torch.uint8:
            pixel_values = pixel_values.float() / 255.0
        vit_tokens, _ = F.extract_feature(model, cfg, pixel_values)
        embeds = F.scatter_image_embeds(input_ids, embeds, vit_tokens,
                                        cfg.img_context_token_id)
    return embeds


def _prefill_chunk(lm: LLM.InternLM2ForCausalLM, cfg: FusionConfig,
                   embeds_chunk: Tensor, chunk_mask: Tensor,
                   cache_row: LLM.KVCache, start: int,
                   logit_row: Optional[int] = None):
    """One prompt segment into a one-row cache at slot ``start``
    (``engine.py:72-85``); ``logit_row`` (the last segment's last valid
    position) asks for the head there alone. Returns (out, cache_row)."""
    rows = None if logit_row is None else slice(logit_row, logit_row + 1)
    return LLM.internlm2_prefill_at(lm, cfg.llm, embeds_chunk, chunk_mask,
                                    cache_row, start,
                                    compute_logits=logit_row is not None,
                                    logit_rows=rows)


def _splice_slot(cache: LLM.KVCache, row: LLM.KVCache, slot: int) -> None:
    """Install a prefilled one-row cache into slot ``slot`` of the shared
    cache, in place (``engine.py:88-101``)."""
    cache.k[:, slot].copy_(row.k[:, 0])
    cache.v[:, slot].copy_(row.v[:, 0])
    cache.mask[slot].copy_(row.mask[0])


@dataclasses.dataclass
class StepState:
    """The decode chunk's static buffers: a captured chunk reads and writes
    these tensors, never others, so the host refills them between
    replays."""
    tokens: Tensor           # [B] int64 current token of each slot
    cache: LLM.KVCache       # [L, B, max_len, n_kv, hd]
    active: Tensor           # [B] bool
    samp: SamplingParams     # [B] each
    uniform: Tensor          # [max_steps, B] f32 draws of sampled rows
    emitted: Tensor          # [B, max_steps] int64 tokens of the chunk


def _engine_step(lm: LLM.InternLM2ForCausalLM, cfg: FusionConfig,
                 st: StepState, n_steps: int, dynamic_sampling: bool,
                 pad_token_id: int, attend_len: Optional[int]) -> Tensor:
    """``n_steps`` continuous-batching decode steps (``engine.py:121-205``):
    ``internlm2_decode_step_multi`` and per-row sampling (greedy argmax
    when ``dynamic_sampling`` is off), inactive rows emitting
    ``pad_token_id``. Rows that hit EOS mid-chunk decode on harmlessly (the
    host trims; re-admission overwrites their cache). Writes st.tokens and
    st.emitted[:, :n_steps] in place and returns the latter."""
    for j in range(n_steps):
        emb = LLM.embed_tokens(lm, st.tokens)[:, None, :]
        logits, _ = LLM.internlm2_decode_step_multi(
            lm, cfg.llm, emb, st.cache, st.active, attend_len=attend_len)
        if dynamic_sampling:
            nxt = sample_token_dynamic(logits, st.samp, uniform=st.uniform[j])
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(st.active, nxt, pad_token_id)
        st.tokens.copy_(nxt)
        st.emitted[:, j].copy_(nxt)
    return st.emitted[:, :n_steps]


class _Backlog(collections.deque):
    """A tensor-parallel engine's intake: what rank 0 took from its queue
    and broadcast, in order, with the queue methods the loop calls."""

    def empty(self) -> bool:
        return not self

    def get_nowait(self):
        if not self:
            raise queue.Empty
        return self.popleft()


@dataclasses.dataclass
class Request:
    """One caption request; ``tokens`` grows as the worker resolves them,
    ``event`` is set when it ends (``error`` if it failed)."""
    input_ids: np.ndarray        # [S] right-packed
    pixel_values: Optional[np.ndarray]
    max_new_tokens: int
    gen: Optional[GenerationConfig] = None  # per-request sampling config
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None
    stream: Optional["queue.Queue"] = None  # per-token ids for streaming
    first_logits: Optional[Tensor] = None   # [V] prefill logits, on device
    t_submit: float = 0.0                   # host clock (perf_counter)
    t_first: float = 0.0
    t_done: float = 0.0


class GenerationEngine:
    """Thread-safe continuous-batching engine over the fusion model.

    ``model`` is on ``device``; ``quant="int8"`` serves a weight-only int8
    copy of its LLM (``quantize_llm_int8``; the model itself is left as it
    is). ``gen`` holds the default sampling config and max_new_tokens; the
    template's separator is EOS. ``phase_stats``: worker wall time by phase
    (admit, dispatch, commits, sync), chunks and decode steps dispatched,
    graphs captured and the capture time, and on the card the device time
    of the replayed chunks (``chunk_device``, from CUDA events).

    ``mesh``: a ``parallel.distributed.Mesh`` with a model group (dp 1):
    the tensor-parallel mode of the module docstring; ``model`` is sharded
    in place."""

    def __init__(self, model: F.ULLSAM, cfg: FusionConfig, tokenizer,
                 max_batch: int = 4, max_len: int = 2560,
                 gen: Optional[GenerationConfig] = None,
                 cache_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 steps_per_dispatch: int = 8, quant: Optional[str] = None,
                 prefill_chunk: int = 256, device="cuda", mesh=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        found = next(model.parameters()).device
        if found.type != self.device.type:
            raise ValueError(f"GenerationEngine: the model is on {found}, "
                             f"the engine on {self.device}")
        lm = model.fusion.language_model
        if quant == "int8" and any(hasattr(p, "tp_split")
                                   for p in lm.parameters()):
            raise ValueError("GenerationEngine: int8 quantizes whole "
                             "weights; give it a model not yet sharded")
        if quant == "int8":
            # weight-only int8 LLM: decode streams every weight once a step
            lm = quantize_llm_int8(copy.deepcopy(lm))
        elif quant is not None:
            raise ValueError(f"unknown quant mode {quant!r}")
        self.mesh = mesh if mesh is not None and mesh.model_group is not None \
            else None
        if self.mesh is not None:
            shard_params(model, self.mesh)
            if lm is not model.fusion.language_model:
                shard_params(lm, self.mesh, prefix="fusion.language_model.")
            self._group = self.mesh.model_group
            self._src = self.mesh.data_index * self.mesh.tp  # model index 0
            self._leader = self.mesh.model_index == 0
        else:
            self._leader = True
        eager = self.device.type != "cuda" or (
            self.mesh is not None and self.mesh.backend == "gloo")
        self.chunk_mode = "eager" if eager else "graph"
        self.model, self.lm, self.cfg = model, lm, cfg
        self.tokenizer = tokenizer
        self.max_batch, self.max_len = max_batch, max_len
        self.sep = get_conv_template(cfg.template).sep.strip()
        base = gen or GenerationConfig(max_new_tokens=256)
        self.gen = dataclasses.replace(
            base, eos_token_id=tokenizer.convert_tokens_to_ids(self.sep),
            pad_token_id=tokenizer.pad_token_id)
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self.prefill_chunk = max(128, prefill_chunk)
        self.cache_dtype = cache_dtype
        dev, B = self.device, max_batch
        self.state = StepState(
            tokens=torch.full((B,), self.gen.pad_token_id, dtype=torch.int64,
                              device=dev),
            cache=LLM.init_cache(cfg.llm, B, max_len, dtype=cache_dtype,
                                 device=dev,
                                 kv_heads=LLM.local_kv_heads(lm)),
            active=torch.zeros(B, dtype=torch.bool, device=dev),
            samp=SamplingParams.from_configs([], pad_to=B, device=dev),
            uniform=torch.zeros((self.steps_per_dispatch, B), device=dev),
            emitted=torch.zeros((B, self.steps_per_dispatch),
                                dtype=torch.int64, device=dev))
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * B
        self.slot_budget = [0] * B
        self.slot_pos = [0] * B          # host-tracked valid lengths
        self.slot_active = [False] * B
        self._pending_admissions: List[dict] = []
        self._step_key = None
        # captured chunks, and the B12 launches of one decode step of each
        # key, counted in its eager warm-up (a replay launches the same
        # kernels without passing through the Python wrapper)
        self.graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self.step_launches: Dict[tuple, float] = {}
        self.replays: Dict[tuple, int] = collections.Counter()
        self._pool = None
        self.phase_stats = collections.defaultdict(float)
        self.error: Optional[BaseException] = None
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._intake = self.queue if self.mesh is None else _Backlog()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- public API -------------------------------------------------------

    def _request_gen(self, temperature, top_p, top_k,
                     do_sample) -> GenerationConfig:
        """Per-request GenerationConfig, engine defaults where None
        (reference caption params: app.py:443-459)."""
        overrides = {k: v for k, v in [("temperature", temperature),
                                       ("top_p", top_p), ("top_k", top_k),
                                       ("do_sample", do_sample)]
                     if v is not None}
        return dataclasses.replace(self.gen, **overrides)

    def prompt_ids(self, question: str, has_image: bool) -> List[int]:
        """The template's chat prompt for ``question``, tokenized."""
        return self.tokenizer.encode(build_chat_prompt(
            self.cfg.template, question,
            num_image_token=self.cfg.num_image_token, has_image=has_image))

    def submit_ids(self, input_ids: Sequence[int],
                   pixel_values: Optional[np.ndarray] = None,
                   max_new_tokens: int = 256,
                   gen: Optional[GenerationConfig] = None,
                   stream: bool = False) -> Request:
        """Enqueue a tokenized prompt; returns its ``Request`` (wait on
        ``request.event``). pixel_values: None, [1, T, T, 3] float in
        [0, 1] or uint8 (converted on the device)."""
        if not self._leader:
            raise RuntimeError("a tensor-parallel engine takes requests on "
                               "model index 0 only")
        if self.error is not None or not self._thread.is_alive():
            raise RuntimeError("GenerationEngine is not running") \
                from self.error
        real = len(input_ids)
        chunk = min(self.prefill_chunk, -(-real // 128) * 128)
        if (real + max_new_tokens > self.max_len
                or -(-real // chunk) * chunk > self.max_len):
            raise ValueError(f"prompt too long ({real} tokens)")
        req = Request(np.asarray(input_ids, np.int64), pixel_values,
                      max_new_tokens, gen=gen or self.gen,
                      stream=queue.Queue() if stream else None,
                      t_submit=time.perf_counter())
        self.queue.put(req)
        return req

    def caption(self, pixel_values: Optional[np.ndarray], question: str,
                max_new_tokens: int = 256, timeout: float = 600.0,
                temperature: Optional[float] = None,
                top_p: Optional[float] = None, top_k: Optional[int] = None,
                do_sample: Optional[bool] = None) -> str:
        """Blocking chat / caption request (thread-safe, batched)."""
        req = self.submit_ids(
            self.prompt_ids(question, pixel_values is not None),
            pixel_values, max_new_tokens,
            self._request_gen(temperature, top_p, top_k, do_sample))
        if not req.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return self.tokenizer.decode(req.tokens).split(self.sep)[0].strip()

    def stream_caption(self, pixel_values: Optional[np.ndarray],
                       question: str, max_new_tokens: int = 256,
                       timeout: float = 600.0,
                       temperature: Optional[float] = None,
                       top_p: Optional[float] = None,
                       top_k: Optional[int] = None,
                       do_sample: Optional[bool] = None):
        """Generator of text deltas (the reference's stream_chat,
        modeling_internlm2.py:1230-1292, on the batched engine): no delta
        ends in U+FFFD, and the text is cut at the separator."""
        req = self.submit_ids(
            self.prompt_ids(question, pixel_values is not None),
            pixel_values, max_new_tokens,
            self._request_gen(temperature, top_p, top_k, do_sample),
            stream=True)
        emitted = ""
        toks: List[int] = []
        while True:
            tok = req.stream.get(timeout=timeout)
            if tok is None:
                break
            toks.append(tok)
            text = self.tokenizer.decode(toks).split(self.sep)[0]
            if len(text) > len(emitted) and not text.endswith("\ufffd"):
                delta, emitted = text[len(emitted):], text
                yield delta
        if req.error is not None:
            raise req.error

    def shutdown(self):
        """Stop the worker (on rank 0 of a tensor-parallel engine this stops
        every rank's, at the next loop)."""
        self._stop.set()
        self._thread.join(timeout=30)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the worker ends: the other ranks of a
        tensor-parallel engine serve until rank 0 shuts down."""
        self._thread.join(timeout)
        if self.error is not None:
            raise self.error

    def _sync_intake(self) -> bool:
        """Top of a worker loop; returns whether to stop. A tensor-parallel
        engine's rank 0 broadcasts what it takes from its queue and its
        stop flag; the other ranks queue the same requests."""
        if self.mesh is None:
            return self._stop.is_set()
        taken = []
        if self._leader:
            while True:
                try:
                    taken.append(self.queue.get_nowait())
                except queue.Empty:
                    break
        msg = [(r.input_ids, r.pixel_values, r.max_new_tokens, r.gen)
               for r in taken]
        msg, stop = D.broadcast_object((msg, self._stop.is_set()),
                                       self._group, self._src)
        if not self._leader:
            taken = [Request(ids, pv, n, gen=gen) for ids, pv, n, gen in msg]
        self._intake.extend(taken)
        return stop

    def _broadcast(self, t: Tensor) -> Tensor:
        """Rank 0's ``t`` on every rank of a tensor-parallel engine."""
        if self.mesh is not None:
            D.broadcast_(t, self._group, self._src)
        return t

    # -- internals --------------------------------------------------------

    def _host_copy(self, t: Tensor):
        """(host tensor, event): a copy of device tensor ``t`` that is
        ready once the event has completed (None on the CPU)."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _host_read(handle) -> np.ndarray:
        host, done = handle
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _row_cache(self) -> LLM.KVCache:
        return LLM.init_cache(self.cfg.llm, 1, self.max_len,
                              dtype=self.cache_dtype, device=self.device,
                              kv_heads=LLM.local_kv_heads(self.lm))

    def _admit_start(self, slot: int, req: Request) -> dict:
        """Begin a chunked admission (``engine.py:439-461``): embed the
        whole prompt (ViT + scatter) and reserve the slot; the LLM prefill
        then advances one ``prefill_chunk`` segment per worker loop."""
        real = len(req.input_ids)
        # segment: at most prefill_chunk, at least the 128-bucketed prompt
        Cc = min(self.prefill_chunk, -(-real // 128) * 128, self.max_len)
        S = -(-real // Cc) * Cc
        padded = np.full((1, S), self.gen.pad_token_id, np.int64)
        padded[0, :real] = req.input_ids
        pv = (None if req.pixel_values is None
              else _to_device(req.pixel_values, self.device))
        embeds = _embed_prompt(self.model, self.lm, self.cfg,
                               _to_device(padded, self.device), pv)
        self.slots[slot] = req                 # reserve (inactive)
        return {"slot": slot, "req": req, "embeds": embeds, "real": real,
                "S": S, "off": 0, "chunk": Cc, "row_cache": self._row_cache()}

    def _admit_advance(self, st: dict):
        """One prompt segment; on the last, finish the admission and return
        the first token's host handle (else None)."""
        Cc, off, real = st["chunk"], st["off"], st["real"]
        last = off + Cc >= st["S"]
        mask = (torch.arange(Cc, device=self.device)
                < real - off).to(torch.int32)[None]
        out, st["row_cache"] = _prefill_chunk(
            self.lm, self.cfg, st["embeds"][:, off:off + Cc], mask,
            st["row_cache"], off, logit_row=real - off - 1 if last else None)
        st["off"] = off + Cc
        if not last:
            return None
        return self._finish_admit(st["slot"], st["req"], out["logits"][:, 0],
                                  st["row_cache"], real)

    def _finish_admit(self, slot: int, req: Request, logits: Tensor,
                      row_cache: LLM.KVCache, real: int):
        """First token, cache splice and slot activation
        (``engine.py:409-423``)."""
        gen = req.gen or self.gen
        if gen.do_sample:
            samp = SamplingParams.from_configs([gen]).map(
                lambda t: _to_device(t, self.device))
            tok = self._broadcast(sample_token_dynamic(
                logits, samp, generator=self.generator))
        else:
            tok = torch.argmax(logits, dim=-1)
        _splice_slot(self.state.cache, row_cache, slot)
        self.state.tokens[slot:slot + 1].copy_(tok)
        req.first_logits = logits[0]
        self.slots[slot] = req
        self.slot_pos[slot] = real
        self.slot_active[slot] = True          # speculatively active
        self.slot_budget[slot] = req.max_new_tokens - 1
        return self._host_copy(tok)

    def _finish(self, slot: int):
        req = self.slots[slot]
        self.slots[slot] = None
        self.slot_active[slot] = False
        self.slot_pos[slot] = 0
        # free the slot: zero its mask so a new request can overwrite it
        self.state.cache.mask[slot].zero_()
        if req is not None:
            req.t_done = time.perf_counter()
            if req.stream is not None:
                req.stream.put(None)  # end-of-stream sentinel
            req.event.set()

    def _attend_bucket(self, active_slots, n_steps: int) -> int:
        """Smallest multiple of 512 covering every active row's valid
        length after this chunk (length-bucketed KV attention)."""
        need = max(self.slot_pos[s] for s in active_slots) + n_steps + 1
        return min(self.max_len, -(-need // 512) * 512)

    def _run_step(self, key) -> Tensor:
        n_steps, attend_len, dynamic = key
        return _engine_step(self.lm, self.cfg, self.state, n_steps, dynamic,
                            self.gen.pad_token_id, attend_len)

    def _graph(self, key) -> torch.cuda.CUDAGraph:
        """The captured chunk of ``key``: on first use, one eager run on a
        side stream (builds the kernels, counts a step's B12 launches; the
        mask and tokens it advanced are restored, and the k / v it wrote lie
        past every row's valid length, where the replay writes the same
        values), then the capture, which records B12's launches without
        running them and so leaves its counts as they were."""
        graph = self.graphs.get(key)
        if graph is not None:
            return graph
        t0 = time.perf_counter()
        st = self.state
        saved = (st.cache.mask.clone(), st.tokens.clone())
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = w8a16_matmul.launches
        with torch.cuda.stream(side):
            self._run_step(key)
        self.step_launches[key] = (w8a16_matmul.launches - before) / key[0]
        torch.cuda.current_stream(self.device).wait_stream(side)
        st.cache.mask.copy_(saved[0])
        st.tokens.copy_(saved[1])
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with uncounted(), torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            self._run_step(key)
        self.graphs[key] = graph
        self.phase_stats["graphs"] += 1
        self.phase_stats["capture"] += time.perf_counter() - t0
        return graph

    def _dispatch_chunk(self, key):
        """Run one decode chunk; returns (host handle of its tokens
        [B, n_steps], its device-time events or None)."""
        n_steps, _, dynamic = key
        st = self.state
        if dynamic:
            self._broadcast(
                st.uniform[:n_steps].uniform_(generator=self.generator))
        if self.chunk_mode == "eager":
            self.phase_stats["eager_chunks"] += 1
            return self._host_copy(self._run_step(key)), None
        graph = self._graph(key)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        self.replays[key] += 1
        return self._host_copy(st.emitted[:, :n_steps]), (start, end)

    def _fail(self, err: BaseException) -> None:
        """A worker fault: every request in the engine and the queue gets
        the error; later submissions raise."""
        self.error = err
        reqs = [r for r in self.slots if r is not None]
        reqs += [st["req"] for st in self._pending_admissions]
        while True:
            try:
                reqs.append(self.queue.get_nowait())
            except queue.Empty:
                break
        for req in reqs:
            req.error = err
            if req.stream is not None:
                req.stream.put(None)
            req.event.set()

    def _worker(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._loop()
        except Exception as e:  # noqa: BLE001 - reported to every request
            traceback.print_exc()
            self._fail(e)

    def _loop(self):
        """Speculative pipelined decode loop (``engine.py:503-713``).

        Each iteration (1) starts admissions into free slots and advances
        their prompt segments, (2) dispatches the next decode chunk from
        the device-resident tokens of the previous one before that chunk's
        results are read, (3) resolves first tokens and (4) consumes the
        oldest in-flight chunk once two are queued. A row that hit EOS or
        its budget decodes on for at most two more chunks (its overrun is
        overwritten on re-admission); results skip rows whose slot was
        finished or re-assigned since dispatch (identity-checked)."""
        ph = self.phase_stats
        st = self.state
        inflight = collections.deque()  # (handle, timing, [(slot, req)], n)
        commits = []          # [(slot, req, handle)] first tokens to read
        intake = self._intake
        while not self._sync_intake():
            # 1a. start chunked admissions into free slots (embeds only)
            _t0 = time.perf_counter()
            for slot in range(self.max_batch):
                if self.slots[slot] is None and not intake.empty():
                    try:
                        req = intake.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        self._pending_admissions.append(
                            self._admit_start(slot, req))
                    except Exception as e:  # noqa: BLE001 - to the caller
                        self.slots[slot] = None
                        req.error = e
                        if req.stream is not None:
                            req.stream.put(None)
                        req.event.set()
            # 1b. one segment a loop while streams decode; with none active
            # (judged before the drain), every pending segment back to back
            advanced = 0
            idle_burst = not any(self.slot_active)
            while self._pending_admissions:
                if advanced >= 1 and not idle_burst:
                    break
                pend = self._pending_admissions[0]
                try:
                    handle = self._admit_advance(pend)
                except Exception as e:  # noqa: BLE001 - to the caller
                    self._pending_admissions.pop(0)
                    self.slots[pend["slot"]] = None
                    pend["req"].error = e
                    if pend["req"].stream is not None:
                        pend["req"].stream.put(None)
                    pend["req"].event.set()
                else:
                    if handle is not None:     # last segment: activated
                        self._pending_admissions.pop(0)
                        commits.append((pend["slot"], pend["req"], handle))
                advanced += 1
            active_slots = [i for i in range(self.max_batch)
                            if self.slot_active[i]]
            _t1 = time.perf_counter()
            ph["admit"] += _t1 - _t0

            # 2. dispatch the next decode chunk (results read two loops on)
            dispatched = None
            if active_slots:
                # one step only when a backlog could take a free slot, else
                # always steps_per_dispatch (odd tails would each be a new
                # graph); the host trims at the budget
                free_slot = len(active_slots) < self.max_batch
                n_steps = (1 if (free_slot and not intake.empty())
                           else self.steps_per_dispatch)
                gens = [(self.slots[i].gen or self.gen)
                        if self.slot_active[i] else None
                        for i in range(self.max_batch)]
                dynamic = any(g is not None and g.do_sample for g in gens)
                step_key = (tuple(self.slot_active),
                            tuple(None if g is None else
                                  (g.temperature, g.top_k, g.top_p,
                                   g.do_sample) for g in gens))
                if step_key != self._step_key:   # admissions changed them
                    self._step_key = step_key
                    _upload(st.active, torch.tensor(self.slot_active))
                    _upload_samp(st.samp, SamplingParams.from_configs(
                        gens, pad_to=self.max_batch))
                key = (n_steps, self._attend_bucket(active_slots, n_steps),
                       dynamic)
                handle, timing = self._dispatch_chunk(key)
                for s in active_slots:
                    # the device's mask advances n_steps for every active
                    # row, EOS or not: the next bucket must cover it
                    self.slot_pos[s] += n_steps
                dispatched = (handle, timing,
                              [(s, self.slots[s]) for s in active_slots],
                              n_steps)
                ph["chunks"] += 1
                ph["steps"] += n_steps
            _t2 = time.perf_counter()
            ph["dispatch"] += _t2 - _t1

            # 3. resolve first tokens
            for slot, req, handle in commits:
                tok = int(self._host_read(handle)[0])
                req.t_first = time.perf_counter()
                req.tokens.append(tok)
                if req.stream is not None:
                    req.stream.put(tok)
                if ((tok == self.gen.eos_token_id
                     or req.max_new_tokens <= 1)
                        and self.slots[slot] is req):
                    self._finish(slot)
            commits = []
            _t3 = time.perf_counter()
            ph["commits"] += _t3 - _t2

            # 4. consume the oldest in-flight chunk (two stay queued while
            # decoding; drain when nothing was dispatched)
            if dispatched is not None:
                inflight.append(dispatched)
            while inflight and (len(inflight) > 2 or dispatched is None):
                handle, timing, rows, n_prev = inflight.popleft()
                em = self._host_read(handle)   # the one host wait a loop
                if timing is not None:
                    ph["chunk_device"] += timing[0].elapsed_time(
                        timing[1]) / 1e3
                for slot, req in rows:
                    if (self.slots[slot] is not req
                            or not self.slot_active[slot]):
                        continue  # finished / re-admitted since dispatch
                    done = False
                    for j in range(n_prev):
                        tok = int(em[slot, j])
                        req.tokens.append(tok)
                        if req.stream is not None:
                            req.stream.put(tok)
                        self.slot_budget[slot] -= 1
                        if (tok == self.gen.eos_token_id
                                or self.slot_budget[slot] <= 0):
                            done = True
                            break
                    if done:
                        self._finish(slot)
            ph["sync"] += time.perf_counter() - _t3

            if (dispatched is None and not active_slots
                    and not self._pending_admissions and self._leader):
                try:
                    req = self.queue.get(timeout=0.05)
                    self.queue.put(req)  # re-enqueue; admit next loop
                except queue.Empty:
                    pass
