"""The four smoke goldens of ``tests/goldens/`` reproduced through
``repro_torch``: each test mirrors the body of
``benchmarks/figN_*.run(smoke=True)`` (the figure's payload, without its
tables and files) on the port's ``exp``/``workload``/``core.energy`` and
compares the values exactly with the golden after a JSON round trip, as
``tests/test_exp.py`` does for the reference. It imports nothing of
``repro`` or ``benchmarks``."""
import json
import os

import pytest

pytest.importorskip("torch")

from torch_sim import port_cache  # noqa: E402,F401

from repro_torch.core import SETUPS  # noqa: E402
from repro_torch.core.energy import ParetoPoint, pareto_frontier  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.exp import (Experiment, Grid, run as run_exp,  # noqa: E402
                             run_grid, sim_count)
from repro_torch.fleet import ControllerSpec  # noqa: E402
from repro_torch.workload import (DEFAULT_INTERACTIVE_SLO,  # noqa: E402
                                  PaperFixedLengths, RatePoint,
                                  crossover_rate, rate_grid)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens")
ARCH = "llama32-3b"
INPUT_LEN, OUTPUT_LEN = 16_384, 256          # the paper's Experiment 1


def _golden(name):
    with open(os.path.join(GOLDENS, name)) as f:
        return json.load(f)


def _as_json(payload):
    return json.loads(json.dumps(payload))


# ----------------------------------------------------------------------
# fig5: the paper's Experiment 2 (DVFS Pareto frontiers)
# ----------------------------------------------------------------------
def fig5_payload():
    grid, batch = (0.42, 0.74, 1.0), 8
    header = ["setup", "phi", "median_ttft_s", "prefill_energy_kj",
              "median_tpot_ms", "decode_energy_kj"]
    header2 = ["setup", "phi_prefill", "phi_decode", "ttft_s", "tpot_ms",
               "stage_energy_kj"]
    base = Experiment.closed(SETUPS[0], batch, arch=ARCH,
                             input_len=INPUT_LEN, output_len=OUTPUT_LEN)
    recs = run_grid(Grid(base, {"setup": SETUPS, "phi": grid}))
    rows, sweeps = [], {}
    for i, setup in enumerate(SETUPS):
        chunk = recs[i * len(grid):(i + 1) * len(grid)]
        pp_pts = [ParetoPoint(phi=phi, latency_s=r.metrics.median_ttft_s,
                              energy_j=r.prefill_side_j, label=setup)
                  for phi, r in zip(grid, chunk)]
        dp_pts = [ParetoPoint(phi=phi, latency_s=r.metrics.median_tpot_s,
                              energy_j=r.decode_side_j, label=setup)
                  for phi, r in zip(grid, chunk)]
        sweeps[setup] = (pp_pts, dp_pts)
        for pp, dp in zip(pp_pts, dp_pts):
            rows.append([setup, pp.phi, round(pp.latency_s, 4),
                         round(pp.energy_j / 1e3, 3),
                         round(dp.latency_s * 1e3, 3),
                         round(dp.energy_j / 1e3, 3)])
    rows2 = []
    for setup in SETUPS:
        if setup.startswith("co"):
            pp_pts, dp_pts = sweeps[setup]
            best = min(
                ({"phi_prefill": pp.phi, "phi_decode": dp.phi,
                  "ttft_s": pp.latency_s, "tpot_s": dp.latency_s,
                  "energy_j": pp.energy_j + dp.energy_j}
                 for pp, dp in zip(pp_pts, dp_pts)),
                key=lambda b: b["energy_j"])
        else:
            pair_recs = run_grid(Grid(base.with_fleet(setup),
                                      {"phi_prefill": grid,
                                       "phi_decode": grid}))
            best = min(
                ({"phi_prefill": pp, "phi_decode": pd,
                  "ttft_s": r.metrics.median_ttft_s,
                  "tpot_s": r.metrics.median_tpot_s,
                  "energy_j": r.prefill_side_j + r.decode_side_j}
                 for (pp, pd), r in zip(
                     ((p, d) for p in grid for d in grid), pair_recs)),
                key=lambda b: b["energy_j"])
        rows2.append([setup, best["phi_prefill"], best["phi_decode"],
                      round(best["ttft_s"], 4),
                      round(best["tpot_s"] * 1e3, 3),
                      round(best["energy_j"] / 1e3, 3)])

    def points(pts):
        return [{"phi": p.phi, "latency_s": round(p.latency_s, 6),
                 "energy_j": round(p.energy_j, 2)} for p in pts]

    by_stage_best = {r[0]: {"phi_prefill": r[1], "phi_decode": r[2],
                            "stage_energy_kj": r[5]} for r in rows2}
    co_best = by_stage_best["co-2gpus"]["stage_energy_kj"]
    dis_best = {s: by_stage_best[s]["stage_energy_kj"]
                for s in SETUPS if s.startswith("dis")}
    return {
        "arch": ARCH, "batch": batch, "phi_grid": list(grid),
        "input_len": INPUT_LEN, "output_len": OUTPUT_LEN,
        "points": [dict(zip(header, r)) for r in rows],
        "best_frequency": [dict(zip(header2, r)) for r in rows2],
        "frontiers": {
            s: {"prefill": points(pareto_frontier(sweeps[s][0])),
                "decode": points(pareto_frontier(sweeps[s][1]))}
            for s in SETUPS},
        "no_dis_energy_win": {
            "co_2gpus_best_kj": co_best,
            "dis_best_kj": dis_best,
            "holds": all(v > co_best for v in dis_best.values()),
        },
    }


# ----------------------------------------------------------------------
# fig6: SLO goodput against offered load, and the crossover rates
# ----------------------------------------------------------------------
def fig6_payload():
    cfg = get_config(ARCH)
    rates, n, seed, slo = (1.0, 2.0, 4.0), 24, 0, DEFAULT_INTERACTIVE_SLO
    dis = ("dis-ici", "dis-host", "dis-disk")
    points = rate_grid(cfg, rates, setups=("co-2gpus",) + dis, slo=slo,
                       n=n, seed=seed)
    rows = [p.as_row() for p in points]
    cache = {(p.setup, p.rate): p.goodput_rps for p in points}
    crossovers = {}
    for setup in dis:
        c = crossover_rate(setup, cfg, baseline="co-2gpus", lo=min(rates),
                           hi=max(rates), iters=2, cache=cache, slo=slo,
                           n=n, seed=seed)
        crossovers[setup] = (None if c is None else
                             {"rate_rps": round(c.rate, 3),
                              "winner_below": c.winner_below,
                              "winner_above": c.winner_above})
    return {
        "arch": ARCH, "n_requests": n, "seed": seed,
        "slo": {"ttft_s": slo.ttft_s, "tpot_s": slo.tpot_s},
        "rates_rps": list(rates),
        "points": [dict(zip(RatePoint.ROW_HEADER, r)) for r in rows],
        "crossovers": crossovers,
    }


# ----------------------------------------------------------------------
# fig8: online governors against the static-frequency frontier
# ----------------------------------------------------------------------
def fig8_payload():
    rates, n, seed, slo = (2.0, 3.0), 16, 0, DEFAULT_INTERACTIVE_SLO
    setups, phi_grid = ("co-2gpus", "dis-ici"), (0.42, 0.58, 0.74, 1.0)
    governors, target = ("queue-depth", "slo-slack"), 0.9

    def cell(setup, rate, phi=None, governor=None):
        exp = Experiment.open(setup, rate, arch=ARCH, n=n, seed=seed,
                              slo=slo)
        if phi is not None:
            exp = exp.with_phi(phi=phi)
        if governor is not None:
            exp = exp.with_governor(governor)
        rec = run_exp(exp)
        return {
            "setup": setup, "rate_rps": rate,
            "attainment": round(rec.attainment, 4),
            "goodput_rps": round(rec.goodput_rps, 4),
            "total_j": round(rec.total_j, 2),
            "active_j": round(rec.total_j - rec.idle_j, 2),
            "idle_j": round(rec.idle_j, 2),
            "j_per_token": round(rec.joules_per_token, 4),
            "decisions": rec.governor_decisions,
            "by_stage": {k: round(v, 2)
                         for k, v in sorted(rec.energy_by_stage.items())},
        }

    records = []
    for setup in setups:
        for rate in rates:
            for phi in phi_grid:
                rec = cell(setup, rate, phi=phi)
                rec["policy"] = f"static-{phi}"
                records.append(rec)
            for gov in governors:
                rec = cell(setup, rate, governor=gov)
                rec["policy"] = gov
                records.append(rec)

    def cells(setup, rate, pred=lambda r: True):
        return [r for r in records if r["setup"] == setup
                and r["rate_rps"] == rate and pred(r)]

    def is_static(r):
        return r["policy"].startswith("static-")

    def attains(r):
        return r["attainment"] >= target

    def frontier(static_pts):
        pts = sorted(static_pts, key=lambda p: (-p["goodput_rps"],
                                                p["total_j"]))
        front, best_e = [], float("inf")
        for p in pts:
            if p["total_j"] < best_e:
                front.append(p)
                best_e = p["total_j"]
        return front

    adaptive_wins = []
    for rate in rates:
        co_static = [r for r in cells("co-2gpus", rate, is_static)
                     if attains(r)]
        gov = [r for r in cells("dis-ici", rate)
               if r["policy"] == "slo-slack" and attains(r)]
        if not co_static or not gov:
            continue
        best_co = min(r["total_j"] for r in co_static)
        if gov[0]["total_j"] <= best_co:
            adaptive_wins.append({"rate_rps": rate,
                                  "governor_j": gov[0]["total_j"],
                                  "best_static_co_j": best_co})
    gaps = {}
    for rate in rates:
        co = [r for r in cells("co-2gpus", rate) if attains(r)]
        dis = [r for r in cells("dis-ici", rate) if attains(r)]
        if co and dis:
            gaps[rate] = round(min(r["total_j"] for r in dis)
                               - min(r["total_j"] for r in co), 2)
    idle_excess = {}
    for rate in rates:
        co = cells("co-2gpus", rate, lambda r: r["policy"] == "static-1.0")
        dis = cells("dis-ici", rate, lambda r: r["policy"] == "static-1.0")
        if co and dis:
            idle_excess[rate] = round(dis[0]["idle_j"] - co[0]["idle_j"], 2)
    return {
        "arch": ARCH, "n_requests": n, "seed": seed,
        "slo": {"ttft_s": slo.ttft_s, "tpot_s": slo.tpot_s},
        "rates_rps": list(rates), "setups": list(setups),
        "phi_grid": list(phi_grid), "governors": list(governors),
        "target_attainment": target,
        "points": records,
        "static_frontier": {
            s: {str(rate): frontier(cells(s, rate, is_static))
                for rate in rates} for s in setups},
        "adaptive_beats_static_co_at": adaptive_wins,
        "idle_floor": {
            "dis_minus_co_best_attaining_j": gaps,
            "dis_minus_co_idle_j_at_phi1": idle_excess,
            "gap_positive_at": [r for r, g in gaps.items() if g > 0],
        },
    }


# ----------------------------------------------------------------------
# fig9: an adaptive fleet controller against the idle-power floor
# ----------------------------------------------------------------------
def fig9_payload():
    slo, n, seed, rates, traffic = DEFAULT_INTERACTIVE_SLO, 60, 0, (20.0,), \
        "diurnal"
    in_len, out_len, co_setup, dis_setup = 1024, 128, "co-4", "4P4D-ici"
    slack = 0.05
    adaptive = ControllerSpec(policy="adaptive", interval_s=0.1,
                              sleep_after_s=0.3, wake_latency_s=0.5,
                              initial_awake_prefill=1,
                              initial_awake_decode=1,
                              target_ttft_s=slo.ttft_s)

    def cell(setup, rate, controller=None):
        exp = Experiment.open(setup, rate, arch=ARCH, n=n, seed=seed,
                              slo=slo, arrival="diurnal",
                              arrival_kw={"period_s": 4.0, "floor": 0.1},
                              lengths=PaperFixedLengths(in_len, out_len))
        if controller is not None:
            exp = exp.with_controller(controller)
        rec = run_exp(exp)
        by_stage = rec.energy_by_stage
        return {
            "traffic": traffic, "rate_rps": rate, "setup": setup,
            "attainment": round(rec.attainment, 4),
            "goodput_rps": round(rec.goodput_rps, 4),
            "total_j": round(rec.total_j, 2),
            "active_j": round(rec.total_j - rec.idle_j
                              - by_stage.get("sleep", 0.0), 2),
            "idle_j": round(rec.idle_j, 2),
            "sleep_j": round(by_stage.get("sleep", 0.0), 2),
            "j_per_token": round(rec.joules_per_token, 4),
            "actions": rec.controller_actions,
            "by_stage": {k: round(v, 2) for k, v in sorted(by_stage.items())},
        }

    records = []
    for rate in rates:
        for setup, ctl, policy in ((co_setup, None, "static"),
                                   (dis_setup, None, "static"),
                                   (dis_setup, adaptive, "adaptive")):
            rec = cell(setup, rate, ctl)
            rec["policy"] = policy
            records.append(rec)

    def find(rate, setup, policy):
        return next(r for r in records if (r["rate_rps"], r["setup"],
                                           r["policy"]) == (rate, setup,
                                                            policy))

    saves, gap_closed, gap_open = [], [], []
    for rate in rates:
        st = find(rate, dis_setup, "static")
        ad = find(rate, dis_setup, "adaptive")
        if (ad["attainment"] >= st["attainment"] - slack
                and ad["total_j"] < st["total_j"]):
            saves.append({"traffic": traffic, "rate_rps": rate,
                          "adaptive_j": ad["total_j"],
                          "static_j": st["total_j"],
                          "saved_frac": round(1 - ad["total_j"]
                                              / st["total_j"], 4)})
        co = find(rate, co_setup, "static")
        entry = {"traffic": traffic, "rate_rps": rate,
                 "adaptive_dis_j": ad["total_j"],
                 "static_co_j": co["total_j"],
                 "gap_j": round(ad["total_j"] - co["total_j"], 2)}
        if (ad["attainment"] >= co["attainment"] - slack
                and ad["total_j"] <= co["total_j"]):
            gap_closed.append(entry)
        else:
            gap_open.append(entry)
    return {
        "arch": ARCH, "n_requests": n, "seed": seed,
        "slo": {"ttft_s": slo.ttft_s, "tpot_s": slo.tpot_s},
        "rates_rps": list(rates), "traffics": [traffic],
        "setups": {"co": co_setup, "dis": dis_setup},
        "input_len": in_len, "output_len": out_len,
        "controller": {"policy": adaptive.policy,
                       "interval_s": adaptive.interval_s,
                       "sleep_after_s": adaptive.sleep_after_s,
                       "wake_latency_s": adaptive.wake_latency_s},
        "attainment_slack": slack,
        "points": records,
        "adaptive_saves_energy_at": saves,
        "gap_closed_at": gap_closed,
        "gap_open_at": gap_open,
    }


FIGURES = {
    "fig5_pareto_smoke.json": fig5_payload,
    "fig6_load_crossover_smoke.json": fig6_payload,
    "fig8_governor_pareto_smoke.json": fig8_payload,
    "fig9_adaptive_fleet_smoke.json": fig9_payload,
}


@pytest.mark.parametrize("golden", sorted(FIGURES))
def test_smoke_figure_matches_golden(golden):
    s0 = sim_count()
    payload = FIGURES[golden]()
    assert sim_count() > s0                 # simulated, not read back
    assert _as_json(payload) == _golden(golden)


def test_fig5_warm_rerun_simulates_nothing():
    fig5_payload()
    s0 = sim_count()
    assert _as_json(fig5_payload()) == _golden("fig5_pareto_smoke.json")
    assert sim_count() == s0

