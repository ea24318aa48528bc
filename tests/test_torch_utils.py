"""The port's debugging and rank-0 logging helpers
(``ullsam_tpu_torch/utils``) against ``tests/test_utils.py:9-40``'s cases,
over modules and state dicts where the JAX package walks pytrees."""

import pytest
import torch

from ullsam_tpu_torch.utils import debug, logging


def test_find_nonfinite_and_assert():
    good = {"a": torch.ones(3), "b.c": torch.zeros(2, 2),
            "ids": torch.arange(3)}
    assert debug.find_nonfinite(good) == []
    bad = {"a": torch.tensor([1.0, float("nan")]),
           "b": torch.tensor([float("inf")]), "ok": torch.ones(2)}
    assert set(debug.find_nonfinite(bad)) == {"a", "b"}
    with pytest.raises(FloatingPointError, match="a"):
        debug.assert_finite(bad)
    lin = torch.nn.Linear(2, 3)
    assert debug.find_nonfinite(lin) == []
    with torch.no_grad():
        lin.bias[1] = float("nan")
    assert debug.find_nonfinite(lin) == ["bias"]


def test_check_finite_has_no_host_sync():
    ok = debug.check_finite({"x": torch.ones(4)})
    assert isinstance(ok, torch.Tensor) and ok.dim() == 0 and bool(ok)
    assert not bool(debug.check_finite({"x": torch.tensor([1.0, 0.0]) / 0}))
    assert bool(debug.check_finite({}))


def test_tree_summary_and_diff():
    a = {"w": torch.ones(2, 3)}
    b = {"w": torch.ones(2, 3) * 1.5}
    s = debug.tree_summary(a)
    assert "w" in s and "(2, 3)" in s and "float32" in s
    d = debug.tree_diff(a, b)
    assert abs(d["w"] - 0.5) < 1e-6
    assert debug.tree_diff(a, a) == {}
    assert debug.tree_diff(a, {}) == {"w": float("inf")}


def test_log0_prints_on_rank_0(capsys):
    logging.log0("hello", 3)
    logging.warn0("careful")
    out = capsys.readouterr()
    assert "hello 3" in out.out and "WARNING: careful" in out.err
