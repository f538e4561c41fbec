"""A cell's data, found by name: ``BENCHMARK.json`` names the cell, its
configuration and its traffic; the files below ``portbench/`` hold them.

  portbench/configs/<config>.json   the model's sizes as run (the port's
                                    ``ModelConfig`` fields), the family's
                                    reference module and its init table
  portbench/traffic/<traffic>.json  the wave: size, lengths, shape seed
  portbench/cells/<cell>.json       the setup (co-1gpu, dis-host, ...),
                                    the correctness sample and its limits

A later cell adds files and entries; nothing here names a cell.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]        # the configuration file as it is run
    traffic: Dict[str, Any]
    cell: Dict[str, Any]          # setup, sample size, limits
    end_to_end: list              # BENCHMARK.json's metric entries
    per_layer: list               # those that list this cell (or all)


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; one of "
                         f"{sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_read(root / cfg_entry["file"]),
        traffic=_read(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        cell=_read(root / "portbench" / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])


def model_config(name: str, config: Dict[str, Any]):
    """The port's ``ModelConfig`` from a configuration file: every key
    that names one of its fields is passed as it stands (nested groups
    as their dataclass); the file's other keys are the benchmark's."""
    from repro_torch.configs import base
    fields = {f.name: f for f in dataclasses.fields(base.ModelConfig)}
    nested = {"rwkv": base.RWKVConfig, "moe": base.MoEConfig,
              "ssm": base.SSMConfig, "hybrid": base.HybridConfig}
    kw = {}
    for key, value in config.items():
        if key not in fields or key == "name":
            continue
        kw[key] = nested[key](**value) if key in nested else value
    return base.ModelConfig(name=name, **kw)
