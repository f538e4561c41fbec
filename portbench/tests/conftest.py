"""The benchmark's own tests, on the CPU unless marked for the card:

  python -m pytest -q portbench/tests

A test that needs the card takes the ``card`` fixture, which skips
without one. The tiny cells under ``data/`` stand in for the real ones
at a size a test run can hold; ``tiny_root`` builds a checkout-like
directory around them with the metrics of the real ``BENCHMARK.json``.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)       # several test workers share the CPU

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {"tiny-dense-dishost": "tiny-dense",
              "tiny-rwkv6-dishost": "tiny-rwkv6",
              "tiny-dense-co1gpu": "tiny-dense"}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("tiny_root")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": c, "source": "test", "file": f"portbench/configs/{c}.json",
         "reduced": [], "why": "test"} for c in sorted(set(TINY_CELLS.values()))]
    bench["workloads"] = [
        {"name": w, "config": c, "traffic": "tiny", "chips": 1, "why": "test"}
        for w, c in TINY_CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(DATA / "portbench", root / "portbench")
    return root
