"""The port's training CLI (``python -m ullsam_tpu_torch.train.cli``)
against the JAX one (``ullsam_tpu.train.cli``) on the CPU: the ``--tiny``
model, one synthetic PNG dataset, one stub tokenizer (the real asset is
not in the repository), both CLIs warm-started from one
``--fusion_checkpoint`` written in the reference's layout from JAX
parameters, so they start from the same weights.

* ``segment`` with ``--grad_accum 2 --instance_matching hungarian`` over
  two epochs (8 micro-steps, 4 updates): each step's metrics in
  ``metrics.jsonl`` and the final parameters;
* ``pretrain`` and ``sft --pack``: each step's losses;
* resuming at the epoch boundary (``--epochs 1``, then ``--epochs 2
  --resume``, one ``--max_steps``) is bitwise equal to never stopping;
* an overlay image is written; ``--dp 2`` and ``--device cuda`` (no card
  here) raise.

Tolerances are ``tests/test_torch_train.py``'s: metrics rtol 1e-5 (atol
1e-7), weights 2e-5 absolute. The JAX CLI runs once per mode (a module
fixture): each run compiles its step.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_init, jax_params_to_numpy,
                                patch_tokenizers, write_synthetic_dataset)

from ullsam_tpu.train import cli as JCLI
from ullsam_tpu_torch.convert.from_jax import fusion_state_dict_from_jax
from ullsam_tpu_torch.train import cli as TCLI

COMMON = ["--tiny", "--max_length", "192", "--batch_size", "1",
          "--log_every", "1", "--ckpt_every", "100", "--dp", "1",
          "--tp", "1", "--sam_max_point_bs", "4"]


def segment_flags(epochs):
    return ["--mode", "segment", "--epochs", str(epochs), "--max_steps", "8",
            "--grad_accum", "2", "--instance_matching", "hungarian",
            "--image_log_every", "2"]


SEGMENT = segment_flags(2)
PRETRAIN = ["--mode", "pretrain", "--epochs", "1", "--max_steps", "2",
            "--grad_accum", "1"]
SFT_PACK = ["--mode", "sft", "--pack", "--epochs", "1", "--max_steps", "2",
            "--grad_accum", "1", "--max_length", "320"]
TIMER_KEYS = {"batch_time", "samples_per_second", "step"}


def _jax_tiny_cfg():
    return JCLI.make_configs(JCLI.build_parser().parse_args(
        ["--tiny", "--data_path", "x"]))


def write_fusion_checkpoint(path, seed=0):
    """JAX ``fusion_init`` weights of the --tiny model (its zero leaves
    drawn) as a reference-named .pt (no ``fusion.`` prefix). Returns the
    JAX params."""
    from ullsam_tpu.models.ullsam import fusion as JF

    jcfg = _jax_tiny_cfg()
    p = jax_params_to_numpy(jax_init(JF.fusion_init, seed, jcfg),
                            np.random.default_rng(seed))
    tcfg = TCLI.make_configs(TCLI.build_parser().parse_args(
        ["--tiny", "--data_path", "x"]))
    sd = fusion_state_dict_from_jax(p, tcfg)
    torch.save({(k[len("fusion."):] if k.startswith("fusion.") else k): v
                for k, v in sd.items()}, path)
    return p


def metrics(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "loss" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    data = {"seg": write_synthetic_dataset(str(root / "seg"), n=4),
            "pretrain": write_synthetic_dataset(str(root / "pt"), n=4,
                                                pretrain=True),
            "sft": write_synthetic_dataset(str(root / "sft"), n=4)}
    ckpt = str(root / "ullsam.pt")
    params = write_fusion_checkpoint(ckpt)
    out = {"root": root, "data": data, "ckpt": ckpt, "params": params}
    with pytest.MonkeyPatch.context() as mp:
        patch_tokenizers(mp)
        for name, flags, ds in (("seg", SEGMENT, "seg"),
                                ("pretrain", PRETRAIN, "pretrain"),
                                ("sft", SFT_PACK, "sft")):
            d = str(root / f"jax_{name}")
            JCLI.main(COMMON + flags + ["--data_path", data[ds],
                                        "--fusion_checkpoint", ckpt,
                                        "--output_dir", d])
            out[f"jax_{name}"] = d
    return out


def _port(runs, monkeypatch, name, flags, ds, extra=()):
    patch_tokenizers(monkeypatch)
    d = str(runs["root"] / f"port_{name}")
    model = TCLI.main(COMMON + flags + [
        "--data_path", runs["data"][ds], "--fusion_checkpoint", runs["ckpt"],
        "--output_dir", d, "--device", "cpu", *extra])
    return d, model


def _same_metrics(port_dir, jax_dir, n):
    got, ref = metrics(port_dir), metrics(jax_dir)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(
        range(1, n + 1))
    for g, r in zip(got, ref):
        assert set(g) - TIMER_KEYS == set(r) - TIMER_KEYS
        for k in set(r) - TIMER_KEYS:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {r['step']} {k}")


def _jax_final_params(jax_dir, ckpt, grad_accum):
    """The JAX run's final params: its checkpoint restored onto the
    trainable partition of the warm start."""
    from ullsam_tpu.convert.torch_fusion import convert_fusion_state_dict
    from ullsam_tpu.convert.torch_sam import load_torch_state_dict
    from ullsam_tpu.train import checkpoint as JK
    from ullsam_tpu.train import step as JS

    params = convert_fusion_state_dict(load_torch_state_dict(ckpt),
                                       _jax_tiny_cfg())
    tx, tr, fr = JS.make_trainable_optimizer(params, JS.TrainConfig(),
                                             grad_accum=grad_accum)
    mgr = JK.CheckpointManager(os.path.join(jax_dir, "ckpt"))
    tr, _, extra = mgr.restore(tr, tx.init(tr))
    mgr.close()
    return jax.tree_util.tree_map(np.asarray, JS.combine_params(tr, fr)), \
        extra


def test_segment_hungarian_grad_accum_matches_jax(runs, monkeypatch):
    d, model = _port(runs, monkeypatch, "seg", SEGMENT, "seg")
    _same_metrics(d, runs["jax_seg"], 8)
    final, extra = _jax_final_params(runs["jax_seg"], runs["ckpt"], 2)
    assert extra == {"step": 8, "epoch": 2}
    want = fusion_state_dict_from_jax(final, model.cfg)
    start = torch.load(runs["ckpt"])
    moved = 0
    for n, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=2e-5,
                                   err_msg=n)
        ref_name = n[len("fusion."):] if n.startswith("fusion.") else n
        moved += not torch.equal(t, start[ref_name])
        if n.startswith("fusion.language_model."):
            assert torch.equal(t, start[ref_name]), n  # frozen
    assert moved
    with open(os.path.join(d, "ckpt", "8", "extra.json")) as f:
        assert json.load(f) == {"step": 8, "epoch": 2}
    images = os.listdir(os.path.join(d, "logs", "images"))
    assert sorted(images) == [f"segmentation_example_{s:08d}.png"
                              for s in (2, 4, 6, 8)]


def test_resume_at_epoch_boundary_is_bitwise(runs, monkeypatch):
    """--epochs 1 then --epochs 2 --resume (one --max_steps, so one
    schedule) against the straight two-epoch run: every step's metrics
    and the final parameters bitwise."""
    straight, m_straight = _port(runs, monkeypatch, "straight", SEGMENT,
                                 "seg")
    d, _ = _port(runs, monkeypatch, "resumed", segment_flags(1), "seg")
    assert [r["step"] for r in metrics(d)] == [1, 2, 3, 4]
    d, m_resumed = _port(runs, monkeypatch, "resumed", SEGMENT, "seg",
                         extra=["--resume"])
    got = metrics(d)
    ref = metrics(straight)
    assert [r["step"] for r in got] == list(range(1, 9))
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k not in TIMER_KEYS} == {
            k: v for k, v in r.items() if k not in TIMER_KEYS}
    for (n, a), b in zip(m_straight.state_dict().items(),
                         m_resumed.state_dict().values()):
        assert torch.equal(a, b), n


def test_pretrain_matches_jax(runs, monkeypatch):
    d, _ = _port(runs, monkeypatch, "pretrain", PRETRAIN, "pretrain")
    _same_metrics(d, runs["jax_pretrain"], 2)


def test_sft_pack_matches_jax(runs, monkeypatch):
    d, _ = _port(runs, monkeypatch, "sft", SFT_PACK, "sft")
    _same_metrics(d, runs["jax_sft"], 2)
    assert all(np.isfinite(r["llm_loss"]) for r in metrics(d))


@pytest.mark.parametrize("flags,error", [
    (["--dp", "2"], NotImplementedError), (["--tp", "2"], NotImplementedError),
    (["--device", "cuda"], RuntimeError)], ids=["dp2", "tp2", "cuda"])
def test_refusals(runs, monkeypatch, flags, error):
    if flags[0] == "--device" and torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device")
    patch_tokenizers(monkeypatch)
    with pytest.raises(error, match="ROADMAP A6|CUDA"):
        TCLI.main(COMMON + PRETRAIN + [
            "--data_path", runs["data"]["pretrain"],
            "--output_dir", str(runs["root"] / "refused"),
            "--device", "cpu", *flags])
