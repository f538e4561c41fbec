"""FleetSpec: the shape of an xP:yD (or n-colocated) serving fleet.

The paper's five experimental setups are the smallest possible fleets —
one or two accelerators. P/D-Serve (arXiv 2408.08147) and FlowKV
(arXiv 2504.03775) show that at production scale the interesting knobs
are the prefill:decode instance *ratio* and how KV transfers are routed
across the pool; ``FleetSpec`` makes both first-class. A spec is a
frozen, hashable value object (sweep caches key on it) that fully
determines the fleet:

  * ``n_prefill`` x ``n_decode`` disaggregated instances with a KV
    ``medium`` (ici / host / disk), every (prefill, decode) pair getting
    its own ``TransferPath``; or ``n_colocated`` instances with no
    transfer at all; or ``n_intra`` intra-GPU-disaggregated accelerators
    (RAPID-Serve): each accelerator SM-partitioned into a prefill slice
    and a decode slice via ``CostModel.slice(intra_split)``, KV shared
    in-place in one pool — a sixth shape *between* co and dis, with
    per-slice phi/power but no transfer leg at all.
  * ``scheduler`` (repro.sched): the per-step batch-composition and
    admission policy of every engine. None = the legacy
    serialize-prefill FCFS engine byte-for-byte (spec encodings omit
    the key so every existing exp-cache hash is preserved).
  * per-instance DVFS settings: ``phi_prefill`` / ``phi_decode`` are a
    scalar (applied to every instance of the stage) or a tuple with one
    entry per instance — heterogeneous-frequency fleets fall out free.
  * ``router`` (frontend: which instance prefills a request) and
    ``kv_router`` (which decode instance receives the KV cache) name
    policies from ``repro.fleet.router``; ``seed`` drives their
    deterministic tie-breaking.

The legacy setup names map through ``FleetSpec.from_setup``: the
``Cluster`` facade in ``repro.core.orchestrator`` is exactly
``FleetCluster(FleetSpec.from_setup(setup), ...)``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

from repro_torch.kvstore import ReuseSpec, as_reuse_spec
from repro_torch.sched import SchedulerSpec, as_scheduler_spec

from .controller import ControllerSpec, as_controller_spec

# mirrors repro.core.orchestrator (defined here to keep the import
# direction fleet <- core.orchestrator acyclic; orchestrator re-exports)
SETUPS = ("co-1gpu", "co-2gpus", "dis-ici", "dis-host", "dis-disk")
DIS_PATH = {"dis-ici": "ici", "dis-host": "host", "dis-disk": "disk"}
MEDIA = ("ici", "host", "disk")

Phi = Union[float, Tuple[float, ...]]


def _canon_phi(value: Phi) -> Phi:
    """Scalar -> float, any sequence -> tuple of floats: list-valued or
    int-valued phis must hash and compare like their canonical twins
    (sweep caches key on the frozen spec)."""
    if isinstance(value, (int, float)):
        return float(value)
    return tuple(float(v) for v in value)


def _per_instance(value: Phi, n: int, what: str) -> Tuple[float, ...]:
    """Broadcast a scalar phi (or validate a per-instance tuple) to n."""
    if isinstance(value, (int, float)):
        vals = (float(value),) * n
    else:
        vals = tuple(float(v) for v in value)
        if len(vals) != n:
            raise ValueError(
                f"{what}: got {len(vals)} per-instance values for "
                f"{n} instances")
    if any(v <= 0 for v in vals):
        raise ValueError(f"{what}: phi must be > 0, got {vals}")
    return vals


@dataclass(frozen=True)
class FleetSpec:
    """x prefill + y decode instances over one KV medium, or n colocated."""
    n_prefill: int = 0
    n_decode: int = 0
    n_colocated: int = 0
    medium: Optional[str] = None        # ici / host / disk (disaggregated)
    phi_prefill: Phi = 1.0              # scalar or per-instance tuple
    phi_decode: Phi = 1.0
    router: str = "least-outstanding-tokens"   # frontend request routing
    kv_router: str = "kv-free-space"           # prefill-done -> decode
    seed: int = 0                              # tie-break determinism
    # online DVFS controller per instance (repro.govern): a registry
    # name applied to every engine, or a tuple with one name per engine
    # (prefill instances first, then decode). "static" keeps the
    # configured phi — bit-identical to pre-governor behavior.
    governor: Union[str, Tuple[str, ...]] = "static"
    # online fleet controller (repro.fleet.controller): autoscaling,
    # P<->D role-flipping, scale-to-zero. None = a static fleet (the
    # pre-controller code path, byte-for-byte — spec encodings omit the
    # key entirely so every existing exp-cache hash is preserved).
    # Accepts a policy name, a ControllerSpec, or a kwargs dict.
    controller: Optional[Union[str, dict, ControllerSpec]] = None
    # KV reuse at the fleet level (repro.kvstore, DESIGN.md section 15):
    # None = no reuse (the pre-reuse code path byte-for-byte — spec
    # encodings omit the key so every existing exp-cache hash is
    # preserved); a flat ReuseSpec attaches one shared PrefixCache to
    # every engine; a ReuseSpec with ``tiers`` set attaches a per-engine
    # TieredKVStore (and makes the fast stepper bail to exact). Accepts
    # a mode string ("prefix"/"pic"), a kwargs dict, or a ReuseSpec.
    reuse: Optional[Union[str, dict, ReuseSpec]] = None
    # per-step batch composition + admission order (repro.sched,
    # DESIGN.md section 17): None = the legacy serialize-prefill FCFS
    # engine byte-for-byte (spec encodings omit the key so every
    # existing exp-cache hash is preserved). Accepts a composer or
    # admission name ("chunked-interleave", "srpt", ...), a kwargs
    # dict, or a SchedulerSpec. Non-coalescible schedulers make the
    # fast stepper bail to exact.
    scheduler: Optional[Union[str, dict, SchedulerSpec]] = None
    # intra-GPU P/D disaggregation (the sixth setup): n_intra
    # accelerators, each split into a prefill slice of ``intra_split``
    # of the SMs/HBM-bandwidth/power rails and a decode slice of the
    # rest. Mutually exclusive with both n_colocated and xP:yD; no
    # medium (the KV pages never move — handoff is free and instant).
    n_intra: int = 0
    intra_split: float = 0.5

    # ------------------------------------------------------------------
    def __post_init__(self):
        object.__setattr__(self, "phi_prefill",
                           _canon_phi(self.phi_prefill))
        object.__setattr__(self, "phi_decode",
                           _canon_phi(self.phi_decode))
        object.__setattr__(self, "intra_split", float(self.intra_split))
        if self.n_intra:
            if self.n_prefill or self.n_decode or self.n_colocated:
                raise ValueError(
                    "a fleet is exactly one shape: got "
                    f"n_intra={self.n_intra} with n_colocated="
                    f"{self.n_colocated} / "
                    f"{self.n_prefill}P:{self.n_decode}D")
            if self.medium is not None:
                raise ValueError(
                    "intra-GPU fleets share KV in place: no medium")
            if not 0.0 < self.intra_split < 1.0:
                raise ValueError(
                    "intra_split is the prefill slice's SM fraction: "
                    f"need 0 < s < 1, got {self.intra_split}")
            if self.controller is not None:
                raise ValueError(
                    "fleet controllers (autoscale / role-flip) do not "
                    "apply to intra-GPU slices: the P/D split is a "
                    "static SM partition of one accelerator")
        elif self.n_colocated:
            if self.n_prefill or self.n_decode:
                raise ValueError(
                    "a fleet is either colocated or disaggregated: got "
                    f"n_colocated={self.n_colocated} with "
                    f"{self.n_prefill}P:{self.n_decode}D")
            if self.medium is not None:
                raise ValueError("colocated fleets have no KV medium")
            if self.n_colocated < 1:
                raise ValueError("n_colocated must be >= 1")
        else:
            if self.n_prefill < 1 or self.n_decode < 1:
                raise ValueError(
                    f"need >= 1 instance per stage, got "
                    f"{self.n_prefill}P:{self.n_decode}D")
            if self.medium not in MEDIA:
                raise ValueError(
                    f"disaggregated fleets need medium in {MEDIA}, "
                    f"got {self.medium!r}")
        if not isinstance(self.governor, str):
            object.__setattr__(self, "governor",
                               tuple(str(g) for g in self.governor))
        if self.controller is not None:
            object.__setattr__(self, "controller",
                               as_controller_spec(self.controller))
        if self.reuse is not None:
            object.__setattr__(self, "reuse", as_reuse_spec(self.reuse))
        if self.scheduler is not None:
            object.__setattr__(self, "scheduler",
                               as_scheduler_spec(self.scheduler))
        # broadcast now so a malformed tuple fails at spec construction
        self.phis_prefill
        self.phis_decode
        self.governors

    # ------------------------------------------------------------------
    @property
    def is_colocated(self) -> bool:
        return self.n_colocated > 0

    @property
    def is_intra(self) -> bool:
        """Intra-GPU P/D disaggregation: P and D slices of ONE
        accelerator, KV shared in-place (no transfer leg)."""
        return self.n_intra > 0

    @property
    def is_disaggregated(self) -> bool:
        """Cross-accelerator disaggregation (KV moves over a medium).
        Intra-GPU fleets are *not* disaggregated in this sense: their
        handoff never leaves HBM."""
        return not self.is_colocated and not self.is_intra

    @property
    def num_engines(self) -> int:
        if self.n_intra:
            return 2 * self.n_intra    # one P slice + one D slice each
        return self.n_colocated or (self.n_prefill + self.n_decode)

    @property
    def phis_prefill(self) -> Tuple[float, ...]:
        n = self.n_colocated or self.n_prefill or self.n_intra
        return _per_instance(self.phi_prefill, n, "phi_prefill")

    @property
    def phis_decode(self) -> Tuple[float, ...]:
        if self.is_colocated:
            return ()
        n = self.n_decode or self.n_intra
        return _per_instance(self.phi_decode, n, "phi_decode")

    @property
    def governors(self) -> Tuple[str, ...]:
        """Per-engine governor names, broadcast like the phis (engine
        order: prefill instances, then decode; or the colocated set).
        Name validity is checked by ``repro.govern.make_governor`` at
        cluster construction, keeping this module import-light."""
        n = self.num_engines
        if isinstance(self.governor, str):
            return (self.governor,) * n
        if len(self.governor) != n:
            raise ValueError(
                f"governor: got {len(self.governor)} per-instance names "
                f"for {n} engines")
        return self.governor

    @property
    def name(self) -> str:
        """Sweep-row label, e.g. ``2P2D-ici``, ``co-2``, ``intra-gpu``."""
        if self.is_intra:
            return "intra-gpu" if self.n_intra == 1 \
                else f"intra-{self.n_intra}"
        if self.is_colocated:
            return f"co-{self.n_colocated}"
        return f"{self.n_prefill}P{self.n_decode}D-{self.medium}"

    # ------------------------------------------------------------------
    @classmethod
    def colocated(cls, n: int, **kw) -> "FleetSpec":
        return cls(n_colocated=n, **kw)

    @classmethod
    def disaggregated(cls, n_prefill: int, n_decode: int,
                      medium: str = "ici", **kw) -> "FleetSpec":
        return cls(n_prefill=n_prefill, n_decode=n_decode, medium=medium,
                   **kw)

    @classmethod
    def from_setup(cls, setup: str, **kw) -> "FleetSpec":
        """The five legacy setups as minimal fleets (the Cluster facade)."""
        if setup not in SETUPS:
            raise ValueError(f"unknown setup {setup!r}; "
                             f"choose from {SETUPS}")
        if setup == "co-1gpu":
            return cls.colocated(1, **kw)
        if setup == "co-2gpus":
            return cls.colocated(2, **kw)
        return cls.disaggregated(1, 1, medium=DIS_PATH[setup], **kw)

    _NAME_RE = re.compile(r"^(\d+)P(\d+)D-(ici|host|disk)$")

    @classmethod
    def parse(cls, name: str, **kw) -> "FleetSpec":
        """Inverse of ``.name`` — ``"2P2D-ici"`` / ``"co-3"`` — also
        accepting the five legacy setup names (CLI flags and sweep-row
        labels round-trip through this)."""
        if name in SETUPS:
            return cls.from_setup(name, **kw)
        if name == "intra-gpu":
            return cls(n_intra=1, **kw)
        if name.startswith("intra-") and name[6:].isdigit():
            return cls(n_intra=int(name[6:]), **kw)
        if name.startswith("co-") and name[3:].isdigit():
            return cls.colocated(int(name[3:]), **kw)
        m = cls._NAME_RE.match(name)
        if m:
            return cls.disaggregated(int(m.group(1)), int(m.group(2)),
                                     m.group(3), **kw)
        raise ValueError(
            f"cannot parse fleet shape {name!r}: expected a setup name "
            f"{SETUPS}, 'co-<n>', 'intra-gpu'/'intra-<n>', or "
            f"'<x>P<y>D-<ici|host|disk>'")

    # ------------------------------------------------------------------
    def with_phi(self, phi: Optional[float] = None,
                 phi_prefill: Optional[Phi] = None,
                 phi_decode: Optional[Phi] = None) -> "FleetSpec":
        """Cluster-style frequency overrides: ``phi`` sets every stage
        unless a stage-specific value is given (the DVFS sweeps use
        this to re-run one spec across the frequency grid)."""
        pp = phi_prefill if phi_prefill is not None else \
            (phi if phi is not None else self.phi_prefill)
        pd = phi_decode if phi_decode is not None else \
            (phi if phi is not None else self.phi_decode)
        return replace(self, phi_prefill=pp, phi_decode=pd)


def as_fleet_spec(setup: Union[str, FleetSpec]) -> FleetSpec:
    """Normalize any accepted setup form — a FleetSpec, a legacy setup
    name, or a fleet-shape string like ``"2P2D-ici"`` / ``"co-3"``."""
    if isinstance(setup, FleetSpec):
        return setup
    return FleetSpec.parse(setup)


def setup_label(setup: Union[str, FleetSpec]) -> str:
    """Human/sweep-row label for either form."""
    return setup if isinstance(setup, str) else setup.name
