"""The rank processes of ``tests/test_torch_parallel.py``: each runs one
case of the port over a gloo process group on the CPU and writes what the
parent compares into the work directory. They import torch and the port,
never jax.

    python tests/torch_parallel_workers.py CASE RANK WORLD WORKDIR

The weights and inputs come from ``WORKDIR/inputs.pt`` (made by the parent
from a numpy seed); the group meets through a ``file://`` store in
WORKDIR; rank r writes ``WORKDIR/out_<r>.pt``.
"""

import os
import sys
import threading

import numpy as np
import torch

from ullsam_tpu_torch.core.device import cpu_warmup
from ullsam_tpu_torch.parallel import distributed as D
from ullsam_tpu_torch.parallel import partitioning as P


def _full(t, like=None):
    return P.full_tensor(t, like).clone()


def case_train(inp, rank):
    """dp 2 x tp 2: the loss of the global batch, then two steps (step 1
    runs at lr 0): metrics, the step-1 gradients and the weights after step
    2, all gathered whole."""
    from ullsam_tpu_torch.models.ullsam import fusion as TF
    from ullsam_tpu_torch.train import step as TS

    cfg, tcfg = inp["cfg"], TS.TrainConfig(**inp["train_kw"])
    model = TF.ULLSAM(cfg, device="cpu")
    model.load_state_dict(inp["weights"])
    mesh = P.create_mesh(dp=inp["dp"], tp=inp["tp"])
    P.shard_params(model, mesh)
    batch = P.shard_batch(inp["batch"], mesh)
    with torch.no_grad():
        loss, _ = TS.seg_loss_fn(model, cfg, tcfg, batch)
    loss = P.mean_over_data({"loss": loss}, mesh)["loss"]
    opt = TS.make_trainable_optimizer(model, tcfg)
    step = TS.make_train_step(cfg, tcfg, model, opt)
    metrics = [step(batch)]
    grads = {n: _full(torch.zeros_like(p) if p.grad is None else p.grad, p)
             for n, p in zip(opt.names, opt.params)}
    metrics.append(step(batch))
    weights = {n: _full(p) for n, p in model.named_parameters()}
    # a checkpoint of whole tensors, written by rank 0, loaded by every
    # rank into a fresh sharded model: each shard and moment comes back
    from ullsam_tpu_torch.train.checkpoint import (CheckpointManager,
                                                   restore_state, save_state)
    ckpt_dir = inp["ckpt_dir"]
    if rank == 0:
        CheckpointManager(ckpt_dir)
    D.barrier()
    save_state(CheckpointManager(ckpt_dir), 2, opt, {"step": 2}, wait=True)
    model2 = TF.ULLSAM(cfg, device="cpu")
    model2.load_state_dict(inp["weights"])
    P.shard_params(model2, mesh)
    opt2 = TS.make_trainable_optimizer(model2, tcfg)
    extra = restore_state(CheckpointManager(ckpt_dir), opt2)
    resumed = (extra == {"step": 2} and opt2.count == opt.count and all(
        torch.equal(a, b) for a, b in zip(opt.params, opt2.params)) and all(
        torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(
            getattr(opt, k), getattr(opt2, k))))
    return {"loss": loss, "metrics": metrics, "grads": grads,
            "weights": weights, "resumed": resumed, "sharded": sorted(
                n for n, p in model.named_parameters() if P.is_sharded(p))}


def _llm(inp, quant):
    from ullsam_tpu_torch.models.internlm2 import model as M
    from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8

    lm = M.InternLM2ForCausalLM(inp["llm_cfg"], device="cpu")
    lm.load_state_dict(inp["llm_weights"])
    if quant:
        quantize_llm_int8(lm)
    return lm


def case_decode(inp, rank):
    """tp = world: the continuous-batching decode step from a faked
    10-token cache (the rank's kv heads of it), in f32 and int8."""
    from ullsam_tpu_torch.models.internlm2 import model as M

    mesh = P.create_mesh(dp=1, tp=inp["tp"])
    cfg = inp["llm_cfg"]
    out = {}
    for quant in (False, True):
        lm = P.shard_params(_llm(inp, quant), mesh,
                            prefix="fusion.language_model.")
        n = M.local_kv_heads(lm)
        heads = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
        cache = M.KVCache(k=inp["k0"][:, :, :, heads].clone(),
                          v=inp["v0"][:, :, :, heads].clone(),
                          mask=inp["mask"].clone(), index=10)
        with torch.no_grad():
            logits, _ = M.internlm2_decode_step_multi(
                lm, cfg, inp["emb"], cache, torch.ones(2, dtype=torch.bool))
        out["int8" if quant else "f32"] = logits
        out["kv_heads"] = n
    return out


def case_engine(inp, rank):
    """tp 2 engine, f32 and int8: three concurrent captions (one with an
    image) on rank 0; the other rank serves until rank 0 shuts down."""
    from torch_port_helpers import StubTokenizer

    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.ullsam import fusion as TF
    from ullsam_tpu_torch.serve.engine import GenerationEngine

    mesh = P.create_mesh(dp=1, tp=inp["tp"])
    out = {}
    for quant in (None, "int8"):
        model = TF.ULLSAM(inp["cfg"], device="cpu")
        model.load_state_dict(inp["weights"])
        eng = GenerationEngine(model, inp["cfg"], StubTokenizer(),
                               max_batch=2, max_len=512,
                               gen=GenerationConfig(max_new_tokens=6),
                               cache_dtype=torch.float32, quant=quant,
                               device="cpu", mesh=mesh)
        out["chunk_mode"] = eng.chunk_mode
        if rank:
            eng.wait(timeout=300)
            continue
        results = {}

        def go(i, q):
            results[i] = eng.caption(inp["image"] if i == 0 else None, q,
                                     max_new_tokens=6)

        threads = [threading.Thread(target=go, args=(i, q))
                   for i, q in enumerate(inp["questions"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        # then one sampled request alone: rank 0's draws, broadcast
        results["sampled"] = eng.caption(None, inp["sampled"],
                                         max_new_tokens=6, do_sample=True,
                                         temperature=1.0, top_k=50)
        eng.shutdown()
        out[quant or "f32"] = results
    return out


def case_amg(inp, rank):
    """One image a rank through ``amg_sharded_sweep``."""
    from ullsam_tpu_torch.inference import amg as TA
    from ullsam_tpu_torch.models.sam import sam as TS

    sam = TS.Sam(inp["sam_cfg"], device="cpu")
    sam.load_state_dict(inp["sam_weights"])
    with torch.no_grad():
        out = TA.amg_sharded_sweep(sam, inp["sam_cfg"], inp["images"],
                                   inp["points"], **inp["amg_kw"])
    return {"sweep": out}


def case_cli(inp, rank):
    """The train CLI at --dp = world size over the same global batch."""
    from torch_port_helpers import StubTokenizer

    from ullsam_tpu_torch.data import tokenizer as tok
    from ullsam_tpu_torch.train import cli as TCLI

    tok.load_tokenizer = lambda path=None: StubTokenizer()
    model = TCLI.main(inp["argv"])
    return {"weights": {n: _full(p) for n, p in model.named_parameters()}}


def case_tp2(inp, rank):
    """The 2-rank cases in one group: the decode step, the engine and the
    image-parallel AMG."""
    return {"decode": case_decode(inp["decode"], rank),
            "engine": case_engine(inp["engine"], rank),
            "amg": case_amg(inp["amg"], rank)}


def main():
    cpu_warmup()        # before the first multi-threaded exp of the rank
    torch.set_num_threads(1)
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    init = "file://" + os.path.join(workdir, "store")
    if case == "cli":   # the CLI starts its group from the environment
        os.environ.update(JAX_COORDINATOR_ADDRESS=init,
                          JAX_NUM_PROCESSES=str(world),
                          JAX_PROCESS_ID=str(rank))
    else:
        D.initialize(init_method=init, world_size=world, rank=rank,
                     device="cpu")
    np.random.seed(0)
    out = globals()["case_" + case](inp, rank)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    D.barrier()
    D.shutdown()


if __name__ == "__main__":
    main()
