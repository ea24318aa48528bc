"""Debugging utilities (``ullsam_tpu/utils/debug.py``): NaN / Inf
detection, parameter tables and diffs, over a module's
``named_parameters`` or a state dict (name -> tensor) where the JAX
package walks pytrees.

``check_finite`` is the in-step check: one 0-d bool tensor on the
tensors' device, with no host sync until the caller reads it (the JAX
package's ``check_finite_jit``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple, Union

import torch

Named = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _named(tree: Named) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.nn.Module):
        return tree.named_parameters()
    return tree.items()


def find_nonfinite(tree: Named) -> List[str]:
    """Names of floating tensors holding a NaN or an Inf (host sync)."""
    return [name for name, t in _named(tree)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def assert_finite(tree: Named, name: str = "tree") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def check_finite(tree: Named) -> torch.Tensor:
    """0-d bool: every floating tensor is finite; no host sync."""
    ok = None
    for _, t in _named(tree):
        if t.is_floating_point():
            fin = torch.isfinite(t).all()
            ok = fin if ok is None else ok & fin
    return torch.tensor(True) if ok is None else ok


def tree_summary(tree: Named, max_rows: int = 0) -> str:
    """One line a tensor: name, shape, dtype and its float64 norm."""
    rows = []
    for name, t in _named(tree):
        t = t.detach()
        norm = (float(torch.linalg.vector_norm(t.double()))
                if t.is_floating_point() else float("nan"))
        rows.append((name, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                     norm))
    if max_rows:
        rows = rows[:max_rows]
    width = max((len(r[0]) for r in rows), default=4)
    return "\n".join(f"{p:<{width}} {str(s):>18} {d:>9} |x|={n:.4g}"
                     for p, s, d, n in rows)


def tree_diff(a: Named, b: Named, atol: float = 0.0) -> Dict[str, float]:
    """Largest absolute difference per name where it exceeds ``atol``
    (inf for a name that ``b`` lacks), in float64."""
    fb = {n: t.detach() for n, t in _named(b)}
    out = {}
    for name, t in _named(a):
        if name not in fb:
            out[name] = float("inf")
            continue
        d = float((t.detach().double().cpu()
                   - fb[name].double().cpu()).abs().max())
        if d > atol:
            out[name] = d
    return out
