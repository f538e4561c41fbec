"""``correct``: what the window served, held to the plain f32 reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests is drawn from the seed, the one with the most
served tokens always in it. For each, the reference runs once over the
prompt and the served tokens (teacher forcing) and gives the logits ``l``
of every position that produced a served token. With ``s`` the standard
deviation of ``l`` at that position (the logits' own scale there):

  token_gap    max over positions of (max(l) - l[served]) / s: how far
               below the reference's best each greedy token lies
  prefill_err  max over the sample of max |prefill logits - l| / s, at
               the last prompt position (the model, flash or the scan)
  decode_err   max over decode positions of |the program's largest
               logit - l[served]| / s (paged attention or the state)
  handoff_bytes  bytes that differ between a handoff's payload before
               the store and after the fetch, over the probed handoffs

The control (``control=True``) puts the reference in the program's place
in fp8 (``reference.lowp``): at each position it takes the token the fp8
model puts first, and the same numbers are read for it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from ..reference import exact_f32, logits as ref_logits
from ..reference.lowp import fp8_mm

SAMPLE = 8          # finished requests held to the reference, each run


def sample(recs, k: int, seed: int) -> List:
    """k finished requests drawn from the seed, the longest among them."""
    done = sorted((r for r in recs.values()
                   if len(r.served) == r.output_len), key=lambda r: r.req)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.output_len + len(r.prompt), -r.req))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 11])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _readings(rows_iter, served, prefill_vec, tops) -> Dict[str, float]:
    """The numbers of one request from the reference's logit rows; the
    chosen token at a position is ``served`` (the program's) or, where
    ``served`` is None, the control's own argmax of ``rows_iter``'s
    second element."""
    gap = pre = dec = 0.0
    for j, ref, other in rows_iter:
        s = ref.std(dim=-1)
        best = ref.max(dim=-1).values
        if served is not None:
            tok = torch.as_tensor(served[j:j + ref.shape[0]],
                                  device=ref.device)
            top = tops[j:j + ref.shape[0]]
        else:
            tok = other.argmax(dim=-1)
            top = other.max(dim=-1).values
        chosen = ref.gather(1, tok[:, None])[:, 0]
        gap = max(gap, float(((best - chosen) / s).max()))
        d = (top - chosen).abs() / s
        if j == 0:
            other0 = prefill_vec if served is not None else other[0]
            pre = max(pre, float((other0 - ref[0]).abs().max() / s[0]))
            d = d[1:]
        if d.numel():
            dec = max(dec, float(d.max()))
    return {"token_gap": gap, "prefill_err": pre, "decode_err": dec}


def _merge(into: Dict[str, float], got: Dict[str, float]) -> None:
    for key, v in got.items():
        into[key] = max(into.get(key, 0.0), v)


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """Each limited number beside its limit, and whether all are within;
    a number that was not read is not within its limit."""
    checks = {k: {"value": readings.get(k), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok


def judge(bench, params, cfg_json: dict, seed: int, control: bool = False,
          k: int = SAMPLE):
    """The largest of each number over ``k`` sampled requests; with
    ``control`` also the fp8 control's numbers on the same sample, as a
    second dict."""
    exact_f32()
    ref = importlib.import_module(
        f"portbench.reference.{cfg_json['reference']}")
    tops: Dict[int, List[float]] = {}
    for ids, t in bench.decode_tops:
        for r, v in zip(ids, t.float().tolist()):
            tops.setdefault(r, []).append(v)
    prog: Dict[str, float] = {}
    ctrl: Dict[str, float] = {}
    dev = params["embed"]["embedding"].device
    for rec in sample(bench.recs, k, seed):
        P, O = len(rec.prompt), rec.output_len
        z = torch.as_tensor(np.concatenate(
            [rec.prompt, np.asarray(rec.served[:-1], dtype=np.int64)]),
            device=dev)
        pv = rec.prefill_logits.float()
        # the program's top logit for each served token: the prefill's
        # own vector for the first, each decode row's for the rest
        prog_tops = torch.tensor([float(pv.max())] + tops.get(rec.req, []),
                                 device=dev)
        if prog_tops.numel() != O:
            raise RuntimeError(f"request {rec.req}: {prog_tops.numel()} "
                               f"logit rows for {O} tokens")
        with torch.no_grad():
            h = ref.hidden(params, cfg_json, z)[P - 1:]
            rows = list(ref_logits(params, cfg_json, h))
            del h
            _merge(prog, _readings(((lo, l, None) for lo, l in rows),
                                   rec.served, pv, prog_tops))
            if control:
                hc = ref.hidden(params, cfg_json, z, fp8_mm)[P - 1:]
                crows = dict(ref_logits(params, cfg_json, hc, fp8_mm))
                del hc
                _merge(ctrl, _readings(((lo, l, crows[lo]) for lo, l in rows),
                                       None, None, None))
    prog["handoff_bytes"] = float(sum(bench.handoff_diffs))
    return (prog, ctrl) if control else prog
