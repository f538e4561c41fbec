"""Grid: cartesian expansion of experiment axes (DESIGN.md section 12).

A ``Grid`` is a base ``Experiment`` plus named axes; ``expand()``
returns the cartesian product as a list of concrete experiments, last
axis fastest (``itertools.product`` order over the axes' insertion
order), so a grid's expansion — hence the order of its records — is
deterministic.

Axis names map to spec transforms:

  setup / fleet   legacy setup name, fleet-shape string, or FleetSpec
  phi             every stage (FleetSpec.with_phi)
  phi_prefill / phi_decode     one stage (scalar or per-instance tuple)
  governor        online DVFS controller name(s)
  batch           ClosedLoop batch size
  rate            OpenLoop nominal arrival rate
  n / seed        workload size / seed
  arch            model architecture id
  slo             scoring SLO
  workload        a whole ClosedLoop / OpenLoop / WorkloadSpec

Anything else must be a dotted dataclass path rooted at the experiment
(e.g. ``workload.input_len``, ``fleet.router``), applied with nested
``dataclasses.replace`` — new knobs are sweepable without touching this
module.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Sequence

from .spec import Experiment, as_workload

__all__ = ["Grid"]


def _set_path(obj, path: List[str], value):
    """Nested frozen-dataclass update along a dotted path."""
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    child = getattr(obj, path[0])
    return dataclasses.replace(
        obj, **{path[0]: _set_path(child, path[1:], value)})


_SETTERS: Dict[str, Callable[[Experiment, Any], Experiment]] = {
    "setup": lambda e, v: e.with_fleet(v),
    "fleet": lambda e, v: e.with_fleet(v),
    "phi": lambda e, v: e.with_phi(phi=v),
    "phi_prefill": lambda e, v: e.with_phi(phi_prefill=v),
    "phi_decode": lambda e, v: e.with_phi(phi_decode=v),
    "governor": lambda e, v: e.with_governor(v),
    "batch": lambda e, v: e.with_workload(batch=v),
    "rate": lambda e, v: e.with_rate(v),
    "n": lambda e, v: e.with_workload(n=v),
    "seed": lambda e, v: e.with_workload(seed=v),
    "arch": lambda e, v: replace(e, arch=v),
    "slo": lambda e, v: replace(e, slo=v),
    "workload": lambda e, v: replace(e, workload=as_workload(v)),
}


def apply_axis(exp: Experiment, name: str, value) -> Experiment:
    setter = _SETTERS.get(name)
    if setter is not None:
        return setter(exp, value)
    if "." in name:
        return _set_path(exp, name.split("."), value)
    raise KeyError(
        f"unknown axis {name!r}: use one of {sorted(_SETTERS)} or a "
        f"dotted dataclass path like 'workload.input_len'")


@dataclass(frozen=True)
class Grid:
    """``Grid(base, {"setup": SETUPS, "batch": (2, 8, 32)})``."""
    base: Experiment
    axes: Mapping[str, Sequence[Any]] = field(default_factory=dict)

    def __post_init__(self):
        for name, values in self.axes.items():
            if not isinstance(values, Sequence) or isinstance(values, str):
                raise TypeError(f"axis {name!r}: values must be a "
                                f"sequence, got {type(values).__name__}")
            if len(values) == 0:
                raise ValueError(f"axis {name!r} is empty")

    def __len__(self) -> int:
        n = 1
        for values in self.axes.values():
            n *= len(values)
        return n

    def expand(self) -> List[Experiment]:
        names = list(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[n] for n in names)):
            exp = self.base
            for name, value in zip(names, combo):
                exp = apply_axis(exp, name, value)
            out.append(exp)
        return out

    def with_axis(self, name: str, values: Sequence[Any]) -> "Grid":
        axes = dict(self.axes)
        axes[name] = values
        return Grid(base=self.base, axes=axes)
