"""The declarative Experiment spec (DESIGN.md section 12).

The paper's contribution is a benchmark *matrix* — setup x KV-transfer
medium x load x frequency — and every knob of one cell lives here as a
frozen value object:

  * ``Experiment``: arch + ``FleetSpec`` (shape, per-instance phi,
    routers, governor) + a workload descriptor + the scoring SLO.
  * ``ClosedLoop``: the paper's RandomDataset (batch at t=0), including
    the RAG-displaced-document variant ``reuse_bench`` measures.
  * ``OpenLoop``: arrival process x length mix x n x seed — the
    DistServe-style load axis.
  * ``ReuseSpec``: the prefix-cache / PIC configuration of the KV-reuse
    experiment (section II-C) — defined in ``repro_torch.kvstore`` (where the
    tiered extension lives, DESIGN.md section 15) and re-exported here.

A spec is canonically JSON-serializable (``to_json`` / ``from_json``
round-trip exactly) and content-addressed: ``spec_hash()`` is the
sha256 of the canonical JSON, stable across processes and Python
versions, and is the cache key of ``repro_torch.exp.cache`` together with the
``RunRecord`` schema version. Everything an ``Experiment`` references —
``FleetSpec``, arrival processes, length mixes, ``SLO`` — is encoded by
registry kind + dataclass fields, so adding a new arrival process or
mix automatically extends the spec language.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.request import Request, SLO, random_workload
from repro_torch.fleet.spec import FleetSpec, as_fleet_spec, setup_label
from repro_torch.kvstore import ReuseSpec, TierSpec, as_reuse_spec
from repro_torch.workload.arrivals import _ARRIVALS, ArrivalProcess
from repro_torch.workload.lengths import (_MIXES, LengthMix, MixtureLengths,
                                    PaperFixedLengths)
from repro_torch.workload.spec import WorkloadSpec

__all__ = ["ClosedLoop", "OpenLoop", "ReuseSpec", "TierSpec",
           "Experiment", "encode_slo", "decode_slo", "registered_arch",
           "apply_spec_knobs", "as_cacheable"]


# ----------------------------------------------------------------------
# registry-based encoding for the polymorphic pieces
# ----------------------------------------------------------------------
_ARRIVAL_KINDS = {cls: kind for kind, cls in _ARRIVALS.items()}
_MIX_KINDS = {cls: kind for kind, cls in _MIXES.items()}
_MIXTURE_KIND = "mixture"


def _encode_fields(obj) -> Dict[str, Any]:
    """Shallow dataclass fields -> JSON-safe dict (tuples become lists)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def encode_arrivals(proc: ArrivalProcess) -> Dict[str, Any]:
    kind = _ARRIVAL_KINDS.get(type(proc))
    if kind is None:
        raise TypeError(
            f"arrival process {type(proc).__name__} is not in the "
            f"repro_torch.workload.arrivals registry; register it to make it "
            f"spec-addressable")
    return {"kind": kind, **_encode_fields(proc)}


def decode_arrivals(d: Dict[str, Any]) -> ArrivalProcess:
    d = dict(d)
    return _ARRIVALS[d.pop("kind")](**d)


def encode_lengths(mix: LengthMix) -> Dict[str, Any]:
    if isinstance(mix, MixtureLengths):
        return {"kind": _MIXTURE_KIND,
                "components": [[w, encode_lengths(m)]
                               for w, m in mix.components]}
    kind = _MIX_KINDS.get(type(mix))
    if kind is None:
        raise TypeError(
            f"length mix {type(mix).__name__} is not in the "
            f"repro_torch.workload.lengths registry; register it to make it "
            f"spec-addressable")
    return {"kind": kind, **_encode_fields(mix)}


def decode_lengths(d: Dict[str, Any]) -> LengthMix:
    d = dict(d)
    kind = d.pop("kind")
    if kind == _MIXTURE_KIND:
        return MixtureLengths(components=tuple(
            (w, decode_lengths(m)) for w, m in d["components"]))
    return _MIXES[kind](**d)


def encode_slo(slo: Optional[SLO]) -> Optional[Dict[str, Any]]:
    if slo is None:
        return None
    return {"ttft_s": slo.ttft_s, "tpot_s": slo.tpot_s}


def decode_slo(d: Optional[Dict[str, Any]]) -> Optional[SLO]:
    if d is None:
        return None
    return SLO(ttft_s=d.get("ttft_s"), tpot_s=d.get("tpot_s"))


def encode_fleet(spec: FleetSpec) -> Dict[str, Any]:
    d = _encode_fields(spec)
    if spec.controller is None:
        # static fleets omit the key entirely: canonical JSON (hence
        # every pre-controller spec hash and cached result) is unchanged
        d.pop("controller")
    else:
        d["controller"] = _encode_fields(spec.controller)
    if spec.reuse is None:
        # same omit-when-None rule for fleet-level KV reuse:
        # every pre-reuse spec hash survives bit-identical
        d.pop("reuse")
    else:
        d["reuse"] = spec.reuse.encode()
    if spec.scheduler is None:
        # omit-when-None again (repro_torch.sched): pre-scheduler hashes pinned
        d.pop("scheduler")
    else:
        d["scheduler"] = _encode_fields(spec.scheduler)
    if spec.n_intra == 0:
        # the intra-GPU shape keys only exist for intra fleets — every
        # co / xP:yD spec hash survives bit-identical
        d.pop("n_intra")
        d.pop("intra_split")
    return d


def decode_fleet(d: Dict[str, Any]) -> FleetSpec:
    d = dict(d)
    for k in ("phi_prefill", "phi_decode", "governor"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    return FleetSpec(**d)


# ----------------------------------------------------------------------
# workload descriptors
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ClosedLoop:
    """The paper's RandomDataset: ``batch`` requests at t=0.

    ``rag_doc_len`` > 0 reproduces the reuse benchmark's RAG workload: a
    shared document of that many tokens is written at ``rag_doc_offset``
    into every prompt (openings differ, so plain prefix matching
    whiffs). ``shared_prefix_len`` > 0 is the simpler identical-prefix
    variant. Both need ``vocab_size`` > 0 (real token ids)."""
    batch: int
    input_len: int = 16_384
    output_len: int = 256
    seed: int = 0
    vocab_size: int = 0
    shared_prefix_len: int = 0
    rag_doc_len: int = 0
    rag_doc_offset: int = 1024

    def build(self, slo: Optional[SLO] = None) -> List[Request]:
        reqs = random_workload(self.batch, input_len=self.input_len,
                               output_len=self.output_len,
                               vocab_size=self.vocab_size, seed=self.seed,
                               shared_prefix_len=self.shared_prefix_len)
        if self.rag_doc_len:
            assert self.vocab_size > 0, "rag_doc_len needs real token ids"
            # same draw order as the historical reuse_bench RAG builder:
            # the shared document comes from its own seeded stream, then
            # is spliced over every prompt at the displacement offset
            rng = np.random.default_rng(self.seed)
            doc = rng.integers(0, self.vocab_size, self.rag_doc_len)
            lo = self.rag_doc_offset
            for r in reqs:
                r.prompt_tokens[lo:lo + self.rag_doc_len] = doc
        if slo is not None:
            for r in reqs:
                r.slo = dataclasses.replace(slo)
        return reqs

    def encode(self) -> Dict[str, Any]:
        return {"kind": "closed", **_encode_fields(self)}


@dataclass(frozen=True)
class OpenLoop:
    """An open-loop workload: arrival process x length mix x n x seed.

    The SLO stamped on the materialized requests is the *experiment's*
    (``Experiment.slo``) — one scoring SLO per cell, the DistServe
    setting — so the same ``OpenLoop`` can be reused across SLO axes."""
    arrivals: ArrivalProcess
    lengths: LengthMix = field(default_factory=PaperFixedLengths)
    n: int = 24
    seed: int = 0
    vocab_size: int = 0

    @classmethod
    def make(cls, rate: float, n: int, *, arrival: str = "poisson",
             lengths: Optional[LengthMix] = None, seed: int = 0,
             vocab_size: int = 0, **arrival_kw) -> "OpenLoop":
        """Mirror of ``repro_torch.workload.open_loop_workload``'s argument
        conventions (incl. the ramp's rate0/ramp_s defaults), returning
        the spec instead of the materialized requests."""
        from repro_torch.workload.arrivals import make_arrivals
        if arrival == "ramp":
            arrival_kw.setdefault("rate1", rate)
            arrival_kw.setdefault("rate0", rate / 4.0)
            arrival_kw.setdefault("ramp_s", 0.5 * n / rate)
            proc = make_arrivals("ramp", **arrival_kw)
        else:
            proc = make_arrivals(arrival, rate=rate, **arrival_kw)
        return cls(arrivals=proc,
                   lengths=lengths if lengths is not None
                   else PaperFixedLengths(),
                   n=n, seed=seed, vocab_size=vocab_size)

    @property
    def rate(self) -> float:
        return self.arrivals.nominal_rate

    def with_rate(self, rate: float) -> "OpenLoop":
        """Same process family at a different nominal rate (the load
        axis of a ``Grid``). Processes with a single ``rate`` field are
        replaced in place; the ramp rescales rate0/rate1 by the ratio."""
        proc = self.arrivals
        if hasattr(proc, "rate"):
            proc = replace(proc, rate=float(rate))
        elif hasattr(proc, "rate1"):
            scale = float(rate) / proc.rate1
            proc = replace(proc, rate0=proc.rate0 * scale,
                           rate1=float(rate))
        else:
            raise TypeError(f"cannot re-rate {type(proc).__name__}")
        return replace(self, arrivals=proc)

    def build(self, slo: Optional[SLO] = None) -> List[Request]:
        return WorkloadSpec(arrivals=self.arrivals, lengths=self.lengths,
                            n=self.n, seed=self.seed, slo=slo,
                            vocab_size=self.vocab_size).build()

    def encode(self) -> Dict[str, Any]:
        return {"kind": "open", "arrivals": encode_arrivals(self.arrivals),
                "lengths": encode_lengths(self.lengths), "n": self.n,
                "seed": self.seed, "vocab_size": self.vocab_size}


Workload = Union[ClosedLoop, OpenLoop]


def decode_workload(d: Dict[str, Any]) -> Workload:
    d = dict(d)
    kind = d.pop("kind")
    if kind == "closed":
        return ClosedLoop(**d)
    if kind == "open":
        return OpenLoop(arrivals=decode_arrivals(d["arrivals"]),
                        lengths=decode_lengths(d["lengths"]), n=d["n"],
                        seed=d["seed"], vocab_size=d.get("vocab_size", 0))
    raise ValueError(f"unknown workload kind {kind!r}")


def as_workload(w) -> Workload:
    """Normalize the accepted workload forms: a descriptor passes
    through; a ``repro_torch.workload.WorkloadSpec`` converts to ``OpenLoop``
    (its embedded SLO is dropped — the experiment's SLO governs)."""
    if isinstance(w, (ClosedLoop, OpenLoop)):
        return w
    if isinstance(w, WorkloadSpec):
        return OpenLoop(arrivals=w.arrivals, lengths=w.lengths, n=w.n,
                        seed=w.seed, vocab_size=w.vocab_size)
    raise TypeError(f"not a workload descriptor: {type(w).__name__}")


# ----------------------------------------------------------------------
@dataclass(frozen=True, eq=True)
class Experiment:
    """One cell of the benchmark matrix, fully determined and hashable.

    ``fleet`` accepts a ``FleetSpec``, a legacy setup name ("dis-ici"),
    or a fleet-shape string ("2P2D-ici"); ``setup`` is the display /
    sweep-row label and defaults to the name the fleet was given (so a
    cell built from "dis-ici" reports as "dis-ici", not "1P1D-ici").

    Identity is content-addressed: ``spec_hash()`` over the canonical
    JSON is the cache key; ``==`` and ``hash()`` follow it.
    """
    arch: str
    fleet: FleetSpec
    workload: Workload
    slo: Optional[SLO] = None
    setup: Optional[str] = None
    reuse: Optional[ReuseSpec] = None
    # simulator knobs that historically traveled as cluster kwargs
    prefill_token_budget: int = 8192
    page_size: int = 16

    def __post_init__(self):
        label = self.setup
        if not isinstance(self.fleet, FleetSpec):
            if label is None and isinstance(self.fleet, str):
                label = self.fleet
            object.__setattr__(self, "fleet", as_fleet_spec(self.fleet))
        object.__setattr__(self, "workload", as_workload(self.workload))
        object.__setattr__(self, "setup",
                           label if label is not None else self.fleet.name)
        if self.reuse is not None and not isinstance(self.reuse,
                                                     ReuseSpec):
            object.__setattr__(self, "reuse", as_reuse_spec(self.reuse))

    # ------------------------------------------------------------------
    # canonical serialization / content address
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "fleet": encode_fleet(self.fleet),
            "workload": self.workload.encode(),
            "slo": encode_slo(self.slo),
            "setup": self.setup,
            "reuse": self.reuse.encode() if self.reuse else None,
            "prefill_token_budget": self.prefill_token_budget,
            "page_size": self.page_size,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Experiment":
        return cls(arch=d["arch"], fleet=decode_fleet(d["fleet"]),
                   workload=decode_workload(d["workload"]),
                   slo=decode_slo(d.get("slo")), setup=d.get("setup"),
                   reuse=as_reuse_spec(d["reuse"]) if d.get("reuse")
                   else None,
                   prefill_token_budget=d.get("prefill_token_budget", 8192),
                   page_size=d.get("page_size", 16))

    def to_json(self) -> str:
        """Canonical form: sorted keys, no whitespace variance — the
        string whose sha256 is the content address."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "Experiment":
        return cls.from_dict(json.loads(s))

    def spec_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    def __hash__(self):
        # SLO is a plain (unhashable) dataclass; identity is the
        # canonical JSON, consistent with the content-addressed cache
        return hash(self.to_json())

    # ------------------------------------------------------------------
    # axis helpers (the Grid's setters; also pleasant by hand)
    # ------------------------------------------------------------------
    def with_fleet(self, fleet) -> "Experiment":
        label = fleet if isinstance(fleet, str) else setup_label(fleet)
        return replace(self, fleet=as_fleet_spec(fleet), setup=label)

    def with_phi(self, phi=None, phi_prefill=None,
                 phi_decode=None) -> "Experiment":
        return replace(self, fleet=self.fleet.with_phi(
            phi=phi, phi_prefill=phi_prefill, phi_decode=phi_decode))

    def with_governor(self, governor) -> "Experiment":
        return replace(self, fleet=replace(self.fleet, governor=governor))

    def with_controller(self, controller) -> "Experiment":
        """Attach (or with None, detach) an online fleet controller —
        a policy name, kwargs dict, or ``ControllerSpec``."""
        return replace(self, fleet=replace(self.fleet,
                                           controller=controller))

    def with_reuse(self, reuse) -> "Experiment":
        """Attach (or with None, detach) experiment-level KV reuse — a
        mode string, kwargs dict (``tiers`` as a nested dict is fine),
        or ``ReuseSpec``. Fleet-level reuse (``FleetSpec.reuse``) is the
        other home: identical simulation, distinct cache hash."""
        return replace(self, reuse=as_reuse_spec(reuse))

    def with_scheduler(self, scheduler) -> "Experiment":
        """Attach (or with None, detach) a per-step scheduler policy
        (repro_torch.sched) — a composer/admission name, kwargs dict, or
        ``SchedulerSpec``. None is the legacy engine byte-for-byte."""
        return replace(self, fleet=replace(self.fleet,
                                           scheduler=scheduler))

    def with_workload(self, **kw) -> "Experiment":
        return replace(self, workload=replace(self.workload, **kw))

    def with_rate(self, rate: float) -> "Experiment":
        return replace(self, workload=self.workload.with_rate(rate))

    # ------------------------------------------------------------------
    # constructors for the two canonical cell families
    # ------------------------------------------------------------------
    @classmethod
    def closed(cls, setup, batch: int, *, arch: str = "llama32-3b",
               input_len: int = 16_384, output_len: int = 256,
               seed: int = 0, slo: Optional[SLO] = None,
               **kw) -> "Experiment":
        """The paper's Experiment-1 cell: ``batch`` requests at t=0."""
        return cls(arch=arch, fleet=setup,
                   workload=ClosedLoop(batch=batch, input_len=input_len,
                                       output_len=output_len, seed=seed),
                   slo=slo, **kw)

    @classmethod
    def open(cls, setup, rate: float, *, arch: str = "llama32-3b",
             n: int = 24, arrival: str = "poisson",
             lengths: Optional[LengthMix] = None, seed: int = 0,
             slo: Optional[SLO] = None, vocab_size: int = 0,
             arrival_kw: Optional[Dict[str, Any]] = None,
             **kw) -> "Experiment":
        """An open-loop cell: named arrival process at ``rate`` req/s."""
        return cls(arch=arch, fleet=setup,
                   workload=OpenLoop.make(rate, n, arrival=arrival,
                                          lengths=lengths, seed=seed,
                                          vocab_size=vocab_size,
                                          **(arrival_kw or {})),
                   slo=slo, **kw)


# ----------------------------------------------------------------------
# the shims' shared gating rules: what may be content-addressed, and how
# legacy cluster kwargs map onto the spec. One definition — the sweep,
# dvfs, and benchmark entrypoints must not drift in what gets cached.
# ----------------------------------------------------------------------
def registered_arch(cfg) -> Optional[str]:
    """``cfg`` -> registry arch name, or None when the config is
    off-registry or a modified copy. Only the registered object itself
    may be content-addressed: a tweaked config under the same name must
    never alias a cached cell of a different cost model."""
    from repro_torch.configs import REGISTRY
    name = getattr(cfg, "name", None)
    if name is not None and REGISTRY.get(name) == cfg:
        return name
    return None


def apply_spec_knobs(exp: "Experiment", kw: Dict[str, Any]):
    """Map the legacy cluster kwargs that have spec equivalents —
    ``phi`` / ``phi_prefill`` / ``phi_decode`` / ``governor`` — onto
    ``exp``. Returns ``(exp, leftovers)``; the caller decides whether
    leftovers are a TypeError (benchmark helpers) or a fall-back to
    direct simulation (the shims)."""
    kw = dict(kw)
    phi = {k: kw.pop(k) for k in ("phi", "phi_prefill", "phi_decode")
           if k in kw}
    if phi:
        exp = exp.with_phi(**phi)
    if "governor" in kw:
        exp = exp.with_governor(kw.pop("governor"))
    if "controller" in kw:
        exp = exp.with_controller(kw.pop("controller"))
    if "reuse" in kw:
        exp = exp.with_reuse(kw.pop("reuse"))
    if "scheduler" in kw:
        exp = exp.with_scheduler(kw.pop("scheduler"))
    return exp, kw


def as_cacheable(exp: "Experiment") -> Optional["Experiment"]:
    """``exp`` iff it can be content-addressed (every polymorphic piece
    is registry-encodable), else None — an unregistered arrival process
    or length mix means direct, uncached simulation."""
    try:
        exp.to_json()
    except TypeError:
        return None
    return exp
