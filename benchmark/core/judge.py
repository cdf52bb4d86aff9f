"""The numbers that decide `correct`, each held to its limit."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(values: Dict[str, float], limits: Dict[str, dict]) -> List[Check]:
    """Every number the cell's limits name; a number the run did not give
    counts as infinitely far off."""
    return [Check(name, float(values.get(name, math.inf)), float(spec['limit']))
            for name, spec in limits.items()]


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def median(values: Iterable[float]) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2]) if n else 0.0


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> List[float]:
    """For each leaf |got - ref| / max(ref, the median leaf's ref): the gap
    between two norms, not the norm of a difference."""
    names = list(leaves if leaves is not None else ref)
    med = median(ref[k] for k in names)
    return [abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in names]


def worst_leaf_gap(got, ref, leaves=None) -> float:
    return max(leaf_gaps(got, ref, leaves), default=math.inf)


def median_leaf_gap(got, ref, leaves=None) -> float:
    gaps = leaf_gaps(got, ref, leaves)
    return median(gaps) if gaps else math.inf


def moving_elements(grad_ref: torch.Tensor, share: float = 1e-3) -> torch.Tensor:
    """The elements of a leaf whose reference gradient is at least `share`
    of the leaf's median element's: the others are nought to rounding."""
    mag = grad_ref.detach().abs()
    return mag >= share * mag.flatten().median()


def moving_leaves(grad_ref: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: the others move under Adam by rounding alone."""
    med = median(grad_ref.values())
    return [k for k, v in grad_ref.items() if v >= share * med]
