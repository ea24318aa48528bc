"""Data and tensor parallelism of the port (``ullsam_tpu_torch/parallel``)
on the CPU: rank processes over gloo (``tests/torch_parallel_workers.py``,
a ``file://`` store in ``tmp_path``; they import no jax) against one
process of the port and the JAX package on the 8-device CPU mesh of
``tests/conftest.py``.

* the sharding rules: every parameter of the tiny fusion model gets JAX's
  ``param_spec`` with the layer axis dropped and a linear's two axes
  swapped, and ``_fit_spec`` agrees at tp 2, vocab 64 and 92,553;
* dp 2 x tp 2 (4 ranks; ``tests/test_train.py:200, :220``): the loss of
  the global batch against one process and JAX's dp 2 x tp 4 mesh at JAX's
  rtol / atol 2e-5; two full steps (the first at lr 0): metrics rtol 2e-5,
  every step-1 gradient within 1e-4 of its tensor's max|g| plus 1e-7 (f32,
  another summation order through the all-reduces), the weights after
  step 2 within 2e-5 of one process's and bitwise equal across the ranks;
  the checkpoint rank 0 writes holds whole tensors, and a fresh sharded
  model restores each rank's shards and moments bitwise;
* the decode step at tp 2 and 4, 8 kv heads (``tests/test_packed.py:115``):
  logits within 2e-5 of one process's (f32 and int8) and of JAX's;
* the engine at tp 2 (``tests/test_engine.py:325``): three concurrent
  greedy captions, one with an image, then one sampled caption (seed 0,
  its draws broadcast from rank 0), the same strings as one process's
  engine, f32 and int8, chunks eager under gloo;
* image-parallel AMG over 2 ranks (``tests/test_amg.py:152``): every
  output of each image bitwise its single-image ``amg_device_sweep``;
* the train CLI at ``--dp 2`` over 2 ranks: each step's metrics rtol 1e-5
  and the final weights 2e-5 of ``--dp 1`` on the same global batch;
* the sharded batch iterator (``tests/test_data_and_train_cli.py:94``) and
  one process's distributed helpers (``tests/test_utils.py:42``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (RankProcesses, StubTokenizer, jax_init,
                                jax_params_to_numpy, patch_tokenizers,
                                run_ranks, tiny_fusion_config,
                                write_synthetic_dataset)

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.internlm2 import model as JM
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu.parallel import partitioning as JP
from ullsam_tpu.train import step as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.parallel import distributed as TD
from ullsam_tpu_torch.parallel import partitioning as TP
from ullsam_tpu_torch.train import cli as TCLI
from ullsam_tpu_torch.train import step as TS

TRAIN_KW = dict(learning_rate=1e-3, total_steps=100)


def _fusion(jcfg, tcfg, seed=0):
    p = jax_params_to_numpy(jax_init(JF.fusion_init, seed, jcfg),
                            np.random.default_rng(seed))
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(X.fusion_state_dict_from_jax(p, tcfg))
    return p, model


def _batch(cfg, rng, B=4, I=3, P=2, Hm=96):
    n = cfg.num_image_token
    ids = np.full((B, n + 8), 5, np.int32)
    ids[:, 2:2 + n] = cfg.img_context_token_id
    S = cfg.sam.vit.img_size
    valid = (np.arange(I)[None] <= rng.integers(0, I, (B, 1))).astype(
        np.float32)
    return {"pixel_values": rng.random((B, S, S, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones_like(ids),
            "point_coords": (rng.random((B, I, P, 2)) * S).astype(np.float32),
            "point_labels": rng.integers(0, 2, (B, I, P)).astype(np.int32),
            "masks": (rng.random((B, I, Hm, Hm)) > 0.7).astype(np.float32),
            "instance_valid": valid}


def _cli_tiny(C):
    return C.FusionConfig(
        sam=C.SamConfig(
            vit=C.ViTConfig(img_size=64, patch_size=8, embed_dim=16,
                            depth=2, num_heads=2, mlp_ratio=2.0,
                            out_chans=16, window_size=2,
                            global_attn_indexes=(1,)),
            prompt_encoder=C.PromptEncoderConfig(
                embed_dim=16, image_embedding_size=(8, 8),
                input_image_size=(64, 64), mask_in_chans=8),
            mask_decoder=C.MaskDecoderConfig(
                transformer_dim=16, transformer_mlp_dim=32,
                transformer_num_heads=2, iou_head_hidden_dim=8)),
        llm=C.InternLM2Config(vocab_size=92553, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=16)


# ---------------------------------------------------------------------------
# the rules, one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [64, 92553])
def test_rules_match_jax(vocab):
    """Each torch parameter's spec is JAX's ``param_spec`` of its JAX path
    (the LLM's layer axis dropped, a linear's axes swapped), and so is
    ``_fit_spec``'s at tp 2 (the 92,553 vocab stays whole); the Megatron
    modules and the gathered tensors are the ones the docstring names."""
    import dataclasses
    tcfg = tiny_fusion_config(TC)
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(
        tcfg.llm, vocab_size=vocab))
    model = TF.ULLSAM(tcfg, device="meta")
    paths = X.jax_param_paths(model)
    mods = dict(model.named_modules())
    jmesh = JP.create_mesh(dp=4, tp=2)
    tmesh = TD.Mesh(dp=1, tp=2)
    n_sharded = 0
    for name, p in model.named_parameters():
        path = paths[name]
        jspec = tuple(JP.param_spec(path, p.ndim))
        linear = isinstance(mods[name.rpartition(".")[0]], L.Linear) and \
            name.endswith(".weight")
        jshape = tuple(p.shape)[::-1] if linear else tuple(p.shape)
        stacked = path.startswith("llm.layers.")
        full_jshape = ((2,) + jshape) if stacked else jshape
        jfit = tuple(JP._fit_spec(JP.P(*jspec), full_jshape, jmesh))
        jspec, jfit = (jspec[1:], jfit[1:]) if stacked else (jspec, jfit)
        jspec = jspec + (None,) * (p.ndim - len(jspec))
        jfit = jfit + (None,) * (p.ndim - len(jfit))
        if linear:                              # [in, out] -> [out, in]
            jspec, jfit = jspec[::-1], jfit[::-1]
        spec = TP.param_spec(name)
        spec = spec + (None,) * (p.ndim - len(spec))
        assert spec == jspec, (name, spec, jspec)
        fit = TP._fit_spec(spec, p.shape, tmesh)
        assert fit == jfit, (name, fit, jfit)
        n_sharded += "model" in fit
    assert n_sharded > 20
    plan, megatron = TP._plan(model, tmesh, "")
    names = {id(m): n for n, m in model.named_modules()}
    assert sorted(names[id(m)] for m in megatron) == [
        "fusion.language_model.model.layers.0",
        "fusion.language_model.model.layers.1", "fusion.mlp1", "fusion.mlp2"]
    modes = {k: v[1] for k, v in plan.items()}
    assert modes["fusion.language_model.model.layers.0.attention.wqkv."
                 "weight"] == "split"
    assert modes["fusion.vision_model.blocks.0.attn.qkv.weight"] == "gather"
    emb = "fusion.language_model.model.tok_embeddings.weight"
    assert (emb in modes) == (vocab == 64)


def test_distributed_single_process():
    """One process: ``initialize`` does nothing and the process is rank 0
    of 1; a 1 x 1 mesh has no groups and a 2-rank one raises."""
    assert TD.initialize(device="cpu") is False
    assert TD.is_main_process() and TD.process_index() == 0
    assert TD.process_count() == 1 and TD.local_device_count() >= 1
    mesh = TP.create_mesh(1, 1)
    assert mesh.data_group is None and mesh.model_group is None
    for dp, tp in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="need 2 processes"):
            TP.create_mesh(dp, tp)
    x = torch.arange(6.0).reshape(2, 3)
    assert TD.copy_to_model(x, mesh) is x
    assert TD.gather_to_main(x)[0] is x


@pytest.mark.parametrize("device,env,card", [
    ("cuda", {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}, 1),
    ("cuda", {"RANK": "5", "WORLD_SIZE": "8"}, 1),
    ("cuda:3", {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}, 3),
], ids=["local_rank", "rank_mod_cards", "explicit_index"])
def test_initialize_binds_rank_to_card(device, env, card, monkeypatch):
    """Under NCCL each rank of a torchrun launch takes its own card (NCCL
    refuses two ranks on one): ``LOCAL_RANK``, else the rank modulo the
    cards seen (4 here), unless the device names its index."""
    import torch.distributed as dist

    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: seen.setdefault("card", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    assert TD.initialize(device=device) is True
    assert seen == {"card": card, "backend": "nccl", "init_method": "env://",
                    "world_size": 8, "rank": 5}


# ---------------------------------------------------------------------------
# dp 2 x tp 2: the loss and the step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory):
    jcfg, tcfg = tiny_fusion_config(JC), tiny_fusion_config(TC)
    p, model = _fusion(jcfg, tcfg)
    batch = _batch(jcfg, np.random.default_rng(1))
    work = tmp_path_factory.mktemp("dp_tp")
    inputs = {"cfg": tcfg, "weights": model.state_dict(), "batch": batch,
              "train_kw": TRAIN_KW, "dp": 2, "tp": 2,
              "ckpt_dir": str(work / "ckpt")}
    pending = RankProcesses("train", 4, str(work), inputs)
    try:
        ref = _dp_tp_references(jcfg, tcfg, p, model, batch)
    finally:
        ranks = pending.join()
    return dict(ref, ranks=ranks, ckpt_dir=inputs["ckpt_dir"])


def _dp_tp_references(jcfg, tcfg, p, model, batch):
    """The one-process step of the port and JAX's loss on a mesh, computed
    while the ranks run."""
    # one process of the port
    tt = TS.TrainConfig(**TRAIN_KW)
    with torch.no_grad():
        loss1, _ = TS.seg_loss_fn(model, tcfg, tt, batch)
    opt = TS.make_trainable_optimizer(model, tt)
    step = TS.make_train_step(tcfg, tt, model, opt)
    metrics = [step(batch)]
    grads = {n: torch.zeros_like(q) if q.grad is None else q.grad.clone()
             for n, q in zip(opt.names, opt.params)}
    metrics.append(step(batch))
    # JAX on a dp 2 x tp 4 mesh
    jt = JS.TrainConfig(**TRAIN_KW)
    mesh = JP.create_mesh(dp=2, tp=4)
    jb = JP.shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh)
    jp = JP.shard_params(jax.tree_util.tree_map(jnp.asarray, p), mesh)
    with jax.sharding.set_mesh(mesh):
        jloss, _ = jax.jit(lambda a, b: JS.seg_loss_fn(a, jcfg, jt, b))(
            jp, jb)
    return {"loss1": float(loss1), "jloss": float(jloss),
            "metrics": metrics, "grads": grads, "opt": opt,
            "weights": dict(model.named_parameters())}


def test_data_parallel_matches_single_device(dp_tp):
    for r in dp_tp["ranks"]:
        np.testing.assert_allclose(float(r["loss"]), dp_tp["loss1"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(r["loss"]), dp_tp["jloss"],
                                   rtol=2e-5, atol=2e-5)


def test_full_train_step_on_mesh(dp_tp):
    ranks = dp_tp["ranks"]
    assert "fusion.language_model.model.layers.0.attention.wqkv.weight" \
        in ranks[0]["sharded"]
    assert "fusion.vision_model.blocks.0.attn.qkv.weight" \
        in ranks[0]["sharded"]
    for r in ranks:
        for i, m in enumerate(r["metrics"]):
            assert set(m) == set(dp_tp["metrics"][i])
            for k in m:
                np.testing.assert_allclose(
                    float(m[k]), float(dp_tp["metrics"][i][k]), rtol=2e-5,
                    atol=1e-7, err_msg=f"step {i} {k}")
    assert set(ranks[0]["grads"]) == set(dp_tp["grads"])
    for n, g in dp_tp["grads"].items():
        for r in ranks:
            np.testing.assert_allclose(
                r["grads"][n].numpy(), g.numpy(),
                atol=1e-4 * float(g.abs().max()) + 1e-7, err_msg=n)
    for n, w in dp_tp["weights"].items():
        np.testing.assert_allclose(ranks[0]["weights"][n].numpy(),
                                   w.detach().numpy(), atol=2e-5, err_msg=n)
        for r in ranks[1:]:
            assert torch.equal(r["weights"][n], ranks[0]["weights"][n]), n


def test_checkpoint_holds_whole_tensors_and_reshards(dp_tp):
    """Rank 0 wrote whole tensors (the one-process shapes, whatever the
    layout), and every rank of a fresh dp 2 x tp 2 model restored its own
    shards and moments bitwise."""
    from ullsam_tpu_torch.train.checkpoint import CheckpointManager

    assert all(r["resumed"] for r in dp_tp["ranks"])
    params, state, extra = CheckpointManager(dp_tp["ckpt_dir"]).restore()
    assert extra == {"step": 2}
    opt = dp_tp["opt"]
    for n, p in zip(opt.names, opt.params):
        assert params[n].shape == p.shape, n
        assert state["mu"][n].shape == p.shape, n
        np.testing.assert_allclose(params[n].numpy(), p.detach().numpy(),
                                   atol=2e-5, err_msg=n)


# ---------------------------------------------------------------------------
# the tensor-parallel decode step and engine
# ---------------------------------------------------------------------------


def _decode_setup(tp):
    """8 kv heads (every tp divides them) and a faked 10-token cache, as
    ``tests/test_packed.py:115``: (JAX config, params, rank inputs)."""
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=8,
              num_key_value_heads=8, max_position_embeddings=2048,
              bias=False, rope_theta=10000.0, pad_token_id=0,
              bos_token_id=1, eos_token_id=2)
    jcfg, tcfg = JC.InternLM2Config(**kw), TC.InternLM2Config(**kw)
    jp = jax_params_to_numpy(jax_init(JM.internlm2_init, 0, jcfg))
    weights = {k: torch.from_numpy(np.array(v)) for k, v in
               X.internlm2_arrays(jp, tcfg).items()}
    rng = np.random.RandomState(0)
    shape = (2, 2, 64, 8, tcfg.head_dim)       # [L, B, max_len, n_kv, hd]
    k0 = (rng.randn(*shape) * 0.1).astype(np.float32)
    v0 = (rng.randn(*shape) * 0.1).astype(np.float32)
    mask = np.zeros((2, 64), np.int32)
    mask[:, :10] = 1
    emb = (rng.randn(2, 1, 64) * 0.1).astype(np.float32)
    T = torch.from_numpy
    return jcfg, jp, {"llm_cfg": tcfg, "llm_weights": weights, "tp": tp,
                      "k0": T(k0), "v0": T(v0), "mask": T(mask),
                      "emb": T(emb)}


ENGINE_QS = ["Describe the image.", "What is shown?", "Name one object."]


@pytest.fixture(scope="module")
def cli_fusion():
    """The CLI's tiny uLLSAM (vocab 92,553, the stub tokenizer's ids) from
    JAX's init: the engine's model, and its SAM is the AMG's."""
    jcfg, tcfg = _cli_tiny(JC), _cli_tiny(TC)
    p, model = _fusion(jcfg, tcfg)
    return tcfg, p, model


def _engine_setup(cli_fusion):
    tcfg, _, model = cli_fusion
    image = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    return model, {"cfg": tcfg, "weights": model.state_dict(), "tp": 2,
                   "image": image, "questions": ENGINE_QS,
                   "sampled": "Tell a story."}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, cli_fusion):
    """One group of 2 gloo ranks for the decode step at tp 2, the tp 2
    engine and image-parallel AMG."""
    decode = _decode_setup(2)
    model, engine = _engine_setup(cli_fusion)
    amg = _amg_setup(cli_fusion)
    tcfg, sam, images, pts, kw = amg
    inputs = {"decode": decode[2], "engine": engine,
              "amg": {"sam_cfg": tcfg, "sam_weights": sam.state_dict(),
                      "images": images, "points": pts, "amg_kw": kw}}
    ranks = run_ranks("tp2", 2, str(tmp_path_factory.mktemp("tp2")), inputs)
    return {"decode": decode, "model": model, "engine": engine,
            "amg": amg, "ranks": ranks}


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_sharded_decode_matches_replicated(tp, ranks2, tmp_path):
    if tp == 2:
        jcfg, jp, inputs = ranks2["decode"]
        ranks = [r["decode"] for r in ranks2["ranks"]]
    else:
        jcfg, jp, inputs = _decode_setup(tp)
        ranks = run_ranks("decode", tp, str(tmp_path), inputs)
    tcfg, B = inputs["llm_cfg"], 2
    ref = {}
    for quant in (False, True):
        lm = TM.InternLM2ForCausalLM(tcfg, device="cpu")
        lm.load_state_dict(inputs["llm_weights"])
        if quant:
            quantize_llm_int8(lm)
        cache = TM.KVCache(k=inputs["k0"].clone(), v=inputs["v0"].clone(),
                           mask=inputs["mask"].clone(), index=10)
        with torch.no_grad():
            ref["int8" if quant else "f32"], _ = TM.internlm2_decode_step_multi(
                lm, tcfg, inputs["emb"], cache, torch.ones(B, dtype=bool))
    jcache = JM.KVCache(k=jnp.asarray(inputs["k0"].numpy()),
                        v=jnp.asarray(inputs["v0"].numpy()),
                        mask=jnp.asarray(inputs["mask"].numpy()),
                        index=jnp.asarray(10, jnp.int32))
    jlogits, _ = JM.internlm2_decode_step_multi(
        jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
        jnp.asarray(inputs["emb"].numpy()), jcache, jnp.ones((B,), bool))
    np.testing.assert_allclose(ref["f32"].numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=2e-5)
    for r in ranks:
        assert r["kv_heads"] == 8 // tp
        for kind in ("f32", "int8"):
            np.testing.assert_allclose(r[kind].numpy(), ref[kind].numpy(),
                                       atol=2e-5, rtol=2e-5, err_msg=kind)


def test_engine_tp_sharded_end_to_end(ranks2):
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.serve.engine import GenerationEngine

    model, inputs = ranks2["model"], ranks2["engine"]
    ranks = [r["engine"] for r in ranks2["ranks"]]
    assert {r["chunk_mode"] for r in ranks} == {"eager"}
    for quant in (None, "int8"):
        eng = GenerationEngine(model, inputs["cfg"], StubTokenizer(),
                               max_batch=2, max_len=512,
                               gen=GenerationConfig(max_new_tokens=6),
                               cache_dtype=torch.float32, quant=quant,
                               device="cpu")
        try:
            ref = [eng.caption(inputs["image"] if i == 0 else None, q,
                               max_new_tokens=6)
                   for i, q in enumerate(ENGINE_QS)]
            ref.append(eng.caption(None, inputs["sampled"], max_new_tokens=6,
                                   do_sample=True, temperature=1.0,
                                   top_k=50))
        finally:
            eng.shutdown()
        got = ranks[0][quant or "f32"]
        assert [got[i] for i in range(len(ENGINE_QS))] + [
            got["sampled"]] == ref, (quant, got)


# ---------------------------------------------------------------------------
# image-parallel AMG
# ---------------------------------------------------------------------------


def _amg_setup(cli_fusion):
    """The SAM of the CLI's tiny uLLSAM, two 48x48 images and a 4x4 grid."""
    from ullsam_tpu_torch.inference.amg import build_point_grid
    from ullsam_tpu_torch.inference.transforms import ResizeLongestSide
    from ullsam_tpu_torch.models.sam import sam as TSam

    fcfg, p, _ = cli_fusion
    tcfg = fcfg.sam
    sam = TSam.Sam(tcfg, device="cpu")
    sam.load_state_dict(X.sam_state_dict_from_jax(p["sam"], tcfg))
    images = (np.random.RandomState(0).rand(2, 48, 48, 3) * 255).astype(
        np.uint8)
    pts = ResizeLongestSide(64).apply_coords(build_point_grid(4) * 48,
                                             (48, 48)).astype(np.float32)
    kw = dict(points_per_batch=8, max_out=16, input_hw=(64, 64),
              out_hw=(48, 48))
    return tcfg, sam, images, pts, kw


def _per_image(tcfg, sam, images, pts, kw):
    from ullsam_tpu_torch.inference import amg as TA
    with torch.no_grad():
        return [TA.amg_device_sweep(
            sam, tcfg, torch.from_numpy(images[i:i + 1]),
            torch.from_numpy(pts), points_per_batch=8, max_out=16,
            pred_iou_thresh=0.0, stability_thresh=0.0, stability_offset=1.0,
            box_nms_thresh=1.0, input_hw=(64, 64), out_hw=(48, 48),
            n_real=len(pts)) for i in range(len(images))]


def _same_sweeps(stacked, refs):
    for d, ref in enumerate(refs):
        assert set(stacked) == set(ref)
        for k, v in ref.items():
            assert torch.equal(stacked[k][d], v), (d, k)
    assert stacked["masks"].any()


def test_amg_sharded_sweep_matches_per_image(ranks2):
    ranks = [r["amg"] for r in ranks2["ranks"]]
    assert ranks[1]["sweep"] is None
    _same_sweeps(ranks[0]["sweep"], _per_image(*ranks2["amg"]))


def test_amg_sharded_sweep_one_process_loops(cli_fusion):
    from ullsam_tpu_torch.inference import amg as TA
    tcfg, sam, images, pts, kw = _amg_setup(cli_fusion)
    with torch.no_grad():
        out = TA.amg_sharded_sweep(sam, tcfg, images, pts, **kw)
    _same_sweeps(out, _per_image(tcfg, sam, images, pts, kw))


# ---------------------------------------------------------------------------
# the train CLI and the sharded iterator
# ---------------------------------------------------------------------------


def _cli_argv(data, out, dp):
    return ["--tiny", "--device", "cpu", "--mode", "segment",
            "--data_path", data, "--output_dir", out, "--batch_size", "2",
            "--grad_accum", "1", "--epochs", "1", "--max_steps", "2",
            "--log_every", "1", "--ckpt_every", "100", "--image_log_every",
            "0", "--max_length", "192", "--sam_max_point_bs", "4",
            "--dp", str(dp), "--tp", "1"]


def _metrics(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_dp2_matches_dp1(tmp_path, monkeypatch):
    """``--dp 2`` over two ranks, one row each, against ``--dp 1`` on the
    same two rows a step: each step's losses and norms, and the final
    weights; rank 0 alone writes the metrics and the checkpoint."""
    data = write_synthetic_dataset(str(tmp_path / "data"))
    out2 = str(tmp_path / "dp2")
    pending = RankProcesses("cli", 2, str(tmp_path / "ranks"),
                            {"argv": _cli_argv(data, out2, 2)})
    try:            # one process while the ranks run
        patch_tokenizers(monkeypatch)
        out1 = str(tmp_path / "dp1")
        model = TCLI.main(_cli_argv(data, out1, 1))
    finally:
        ranks = pending.join()
    m1, m2 = _metrics(out1), _metrics(out2)
    assert len(m1) == len(m2) == 2
    timing = {"batch_time", "samples_per_second", "step"}
    for a, b in zip(m1, m2):
        for k in set(a) - timing:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for n, w in model.named_parameters():
        for r in ranks:
            np.testing.assert_allclose(r["weights"][n].numpy(),
                                       w.detach().numpy(), atol=2e-5,
                                       err_msg=n)
    assert sorted(os.listdir(os.path.join(out2, "ckpt"))) == ["2"]


def test_batch_iterator_sharding(tmp_path):
    """Data rank r of dp takes order[r::dp]: one rank's batches of 2 rows
    out of 4, and over the ranks each global step holds one process's rows
    (``batch_size / dp`` rows a rank)."""
    from ullsam_tpu_torch.data.datasets import (DatasetConfig, SegDataset,
                                                batch_iterator_sharded)

    jsonl = write_synthetic_dataset(str(tmp_path))
    cfg = DatasetConfig(data_path=jsonl, max_length=64, img_size=64,
                        num_image_token=16, sam_max_point_bs=2)
    ds = SegDataset(cfg, StubTokenizer())
    batches = list(batch_iterator_sharded(ds, 2, process_index=0,
                                          process_count=2, shuffle=False))
    assert len(batches) == 1  # 4 rows / 2 processes / batch 2
    assert batches[0]["input_ids"].shape == (2, 64)
    whole = list(batch_iterator_sharded(ds, 2, seed=3))
    parts = [list(batch_iterator_sharded(ds, 1, seed=3, process_index=r,
                                         process_count=2)) for r in range(2)]
    for k, b in enumerate(whole):
        rows = np.concatenate([parts[0][k]["pixel_values"],
                               parts[1][k]["pixel_values"]])
        np.testing.assert_array_equal(rows, b["pixel_values"])
