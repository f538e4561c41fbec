"""``repro_torch`` stands alone: importing every one of its modules pulls
in neither jax nor the reference package, and neither its sources nor
``chip_smoke.py`` (which drives it on the card) import them."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 40, out.stdout
    assert bad == "[]", f"repro_torch pulled in {bad}"


def test_port_sources_name_neither_jax_nor_reference():
    paths = [*(SRC / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)}: {s}"


@pytest.mark.parametrize("module", ["repro_torch.dist.opt_flags",
                                    "repro_torch.dist.sharding",
                                    "repro_torch.launch.mesh"])
def test_placement_modules_stand_alone(module):
    """The flags and placement modules, imported alone, pull in neither
    jax nor the reference, and create no process group."""
    probe = (f"import sys, importlib\n"
             f"importlib.import_module({module!r})\n"
             f"import torch.distributed as dist\n"
             f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"('jax', 'jaxlib', 'repro'))\n"
             f"print(bad, dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"
