"""Shared by the port's simulator tests: the reference and the port side
by side (``REF.exp`` is ``repro.exp``, ``PORT.exp`` is
``repro_torch.exp``), and the port's process-default result cache kept in
each test's tmpdir, so that a record the port returns is one it
simulated there."""
import importlib

import pytest


class Pkg:
    """``Pkg("repro").workload`` is ``repro.workload``, and so on."""

    def __init__(self, root):
        self.root = root

    def __getattr__(self, name):
        return importlib.import_module(f"{self.root}.{name}")


REF, PORT = Pkg("repro"), Pkg("repro_torch")


@pytest.fixture(autouse=True)
def port_cache(tmp_path):
    """The port's process-default result cache in this test's tmpdir."""
    PORT.exp.set_default_cache(PORT.exp.ResultCache(str(tmp_path / "c")))
    yield
    PORT.exp.set_default_cache(None)
