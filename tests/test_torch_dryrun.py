"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's.

``with_periods``, ``full_periods`` and every skip record equal the
reference's (computed in a subprocess: ``repro.launch.dryrun`` forces
512 host devices at import). qwen2-0.5b's decode_32k cell on the 16x16
mesh is ``ok`` at full width with its roofline, as the reference's own
test asks, and its ``argument_bytes`` equal rank 0's bytes worked out
from the reference's ``PartitionSpec``s and the mesh's axis sizes, with
no compile. The port's cell runs on fake tensors under a fake process
group of 256 ranks that it makes and destroys itself.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.compat import abstract_mesh as r_abstract_mesh  # noqa: E402
from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.dist import sharding as RS  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro_torch.configs import ALL_SHAPES, REGISTRY  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

_REFERENCE = r"""
import dataclasses, json
from repro.configs import ALL_SHAPES, REGISTRY
from repro.launch.dryrun import full_periods, run_cell, with_periods
from repro.configs import applicable
out = {"periods": {}, "skips": []}
for name, cfg in REGISTRY.items():
    out["periods"][name] = {
        "full": full_periods(cfg),
        "with": [dataclasses.asdict(with_periods(cfg, n)) for n in (1, 2, 3)]}
    for shape in ALL_SHAPES:
        if not applicable(cfg, shape):
            for mp in (False, True):
                out["skips"].append(run_cell(name, shape.name, mp,
                                             verbose=False))
print("REF:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REF:")]
    return json.loads(line[0][4:])


def test_periods_equal_reference(reference):
    for name, cfg in REGISTRY.items():
        ref = reference["periods"][name]
        assert dryrun.full_periods(cfg) == ref["full"], name
        for n, want in zip((1, 2, 3), ref["with"]):
            got = json.loads(json.dumps(dataclasses.asdict(
                dryrun.with_periods(cfg, n))))
            assert got == want, (name, n)


def test_skip_records_equal_reference(reference):
    assert reference["skips"]
    for ref in reference["skips"]:
        rec = dryrun.run_cell(ref["arch"], ref["shape"],
                              ref["mesh"] == "2x16x16", verbose=False)
        assert rec == ref


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    """Rank 0's bytes of the reference's decode arguments on the 16x16
    mesh, from its PartitionSpecs: each sharded dim holds
    ceil(size / ways), as XLA pads."""
    sizes = {"data": 16, "model": 16}
    mesh = r_abstract_mesh((16, 16), ("data", "model"))
    cfg, shape = r_get_config(arch), R_SHAPES[shape_name]
    model = r_get_model(cfg)
    params = model.abstract_params()
    inputs = model.decode_inputs(shape)
    tok = ("data",) if shape.global_batch % 16 == 0 else None
    placed = [(leaf, sh.spec) for leaf, sh in zip(
        jax.tree.leaves(params),
        jax.tree.leaves(RS.param_shardings(cfg, params, mesh)))]
    placed += [(leaf, RS.state_spec(leaf.shape, mesh))
               for leaf in jax.tree.leaves(inputs["state"])]
    placed += [(inputs["tokens"], (tok,)), (inputs["pos"], (tok,))]
    total = 0
    for leaf, spec in placed:
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
        n = 1
        for d, entry in zip(leaf.shape, spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= -(-d // math.prod(sizes[a] for a in names))
        total += n * leaf.dtype.itemsize
    return total


def test_qwen2_decode_cell_ok_at_full_width():
    """The reference's own dry-run test's cell, with the roofline, and
    its argument bytes against the reference's placements."""
    assert not dist.is_initialized()
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", False, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert not dist.is_initialized()          # the fake group is gone
    r = rec["roofline"]
    assert r["flops"] > 0 and r["hbm_bytes"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["vmem_resident_bytes"] == 0.0 and rec[
        "vmem_resident_estimate"] > 0
    assert rec["argument_bytes"] == _reference_argument_bytes(
        "qwen2-0.5b", "decode_32k")
    assert rec["output_bytes"] > 0 and rec["temp_bytes"] > 0
    assert set(rec["collectives_rolled"]["count_by_kind"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "collective-permute",
        "all-to-all"}


def test_run_cell_refuses_a_process_with_a_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
    try:
        with pytest.raises(RuntimeError, match="subprocess"):
            dryrun.run_cell("qwen2-0.5b", "decode_32k", False,
                            verbose=False)
    finally:
        dist.destroy_process_group()


def test_every_shape_is_named():
    assert [s.name for s in ALL_SHAPES] == list(R_SHAPES)
