"""Each cell of ``BENCHMARK.json`` finds its files by name, the
configuration files build the port's config as they state it, and the
work counted for the rooflines and the step's share of the peak matches
counts written out by hand for one small shape."""
import ast
import json
import subprocess
import sys

import pytest

from conftest import REPO
from portbench.harness import layers, roofline, spec
from portbench.reference import dense, rwkv6

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = spec.load_cell(REPO, name)
    cfg = spec.model_config(c.config_name, c.config)
    for key, value in c.config.items():
        if hasattr(cfg, key) and not isinstance(value, dict) \
                and key != "name":
            assert getattr(cfg, key) == value, key
    assert c.cell["setup"] in ("co-1gpu", "dis-host")
    assert set(c.cell["limits"]) <= {"token_gap", "prefill_err",
                                     "decode_err", "handoff_bytes"}
    assert c.traffic["wave"] > 0
    assert c.end_to_end and c.per_layer
    for m in c.per_layer:
        assert callable(layers.load(m["name"]).read)


def test_every_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        assert (layers.METRICS / f"{m['name']}.py").is_file(), m["name"]


def test_configs_keep_the_published_widths():
    yi = json.loads((REPO / "portbench/configs/yi-34b-30l.json").read_text())
    assert (yi["d_model"], yi["num_heads"], yi["num_kv_heads"],
            yi["head_dim"], yi["d_ff"], yi["vocab_size"]) == \
        (7168, 56, 8, 128, 20480, 64000)
    assert yi["num_layers"] * 2 == yi["published"]["num_layers"]
    rw = json.loads((REPO / "portbench/configs/rwkv6-3b.json").read_text())
    assert (rw["num_layers"], rw["d_model"], rw["d_ff"]) == (32, 2560, 8960)


def test_flash_work_written_out():
    # S = 3 causal: 6 pairs; H 4, KV 2, hd 8: 4 * 4 * 8 * 6 flops;
    # q and o 3*4*8 each, k and v 3*2*8 each, 2 bytes an element
    assert roofline.flash_work(3, 4, 2, 8) == (768.0, (96 * 2 + 48 * 2) * 2)


def test_paged_work_written_out():
    # lens 5 and 17, page 16: 22 live rows, 2 pages at most;
    # H 4, KV 2, hd 8: 4*4*8*22 flops; K and V 2*22*2*8 elements, q and o
    # 2*2*4*8, a 2 x 2 block table and 2 lengths in int32
    f, b = roofline.paged_work([5, 17], 4, 2, 8, 16)
    assert f == 4 * 4 * 8 * 22
    assert b == (2 * 22 * 2 * 8 + 2 * 2 * 4 * 8) * 2 + 4 * 4 + 2 * 4


def test_rwkv6_scan_work_written_out():
    # T 64, NH 2, hd 4: 4*64*2*16 flops; r, k, v, y bf16; w f32; u and
    # the final state f32
    f, b = roofline.rwkv6_scan_work(64, 2, 4)
    assert f == 4 * 64 * 2 * 16
    assert b == 4 * 64 * 8 * 2 + 64 * 8 * 4 + 8 * 4 + 2 * 16 * 4


def test_step_work_written_out():
    cfg = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
           "head_dim": 4, "d_ff": 16, "vocab_size": 10}
    # a layer: q and o 8*8 each, k and v 8*4 each, three 8*16 matrices
    per_layer = 64 * 2 + 32 * 2 + 3 * 128
    weights = (2 * per_layer + 80) * 2
    f, b = dense.prefill_work(cfg, 3)
    assert f == 2 * 2 * per_layer * 3 + 4 * 2 * 2 * 4 * 6 + 2 * 80
    assert b == weights + 2 * 2 * 3 * 1 * 4 * 2
    f, b = dense.decode_work(cfg, [3, 5])
    assert f == 2 * 2 * (2 * per_layer + 80) + 4 * 2 * 2 * 4 * 10
    assert b == weights + 2 * 2 * 12 * 4 * 2
    rw = {"num_layers": 1, "d_model": 8, "d_ff": 16, "vocab_size": 10,
          "rwkv": {"head_dim": 4, "decay_lora": 2, "mix_lora": 3}}
    lay = 6 * 64 + 8 * 15 + 15 * 8 + 2 * 8 * 2 + 2 * 8 * 16
    f, _ = rwkv6.prefill_work(rw, 5)
    assert f == 2 * lay * 5 + 4 * 5 * 8 * 4 + 2 * 80


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)


# ----------------------------------------------------------------------
# the import guard
# ----------------------------------------------------------------------
def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """A whole run in a fresh process, then the top-level names of every
    module it loaded, compared whole: ``repro_torch`` is not ``repro``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        "assert run.main(['--workload', 'tiny-dense-dishost', '--seed', '5',"
        " '--seconds', '0.3'], root=Path(%r), device='cpu') == 0\n"
        "from portbench.harness import guard\n"
        "print('LOADED', guard.loaded(), 'repro_torch' in {m.split('.')[0]"
        " for m in sys.modules})\n") % (str(REPO), str(REPO / "src"),
                                      str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED [] True" in out.stdout


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import portbench.reference.dense, portbench.reference.rwkv6\n"
            "import portbench.reference.lowp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax'}))\n") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(n.split(".")[0] in ("repro_torch", "repro", "jax")
                           for n in names), (path, names)


def test_guard_compares_whole_names(monkeypatch):
    from portbench.harness import guard
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro" not in guard.loaded()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert guard.loaded() == ["repro"]


def test_card_record_and_energy_counter(card):
    """On the card only: NVML reads the card's name, limit and clocks,
    and its energy counter moves under load."""
    import torch
    from portbench.harness import nvml
    uid = str(torch.cuda.get_device_properties(0).uuid)
    c = nvml.Card(uid if uid.startswith("GPU-") else "GPU-" + uid)
    rec = c.record()
    assert rec["power_limit_w"] > 0 and rec["sm_clock_mhz"] > 0
    sm, watts, temp, _ = c.state()
    assert sm > 0 and watts > 0 and temp > 0
    e0 = c.energy_mj()
    x = torch.randn(8192, 8192, device=card)
    for _ in range(200):
        x = x @ x / 90.0
    torch.cuda.synchronize()
    assert c.energy_mj() > e0


def test_device_trace_reduction():
    """The union of device intervals, the idle share, per-kernel seconds
    and the idle gaps by the host call around them, on a trace written
    out: busy 0-1 and 2-3 of a 0-4 window, the gap 1-2 inside a decode
    call and 3-4 outside every call."""
    import numpy as np
    from portbench.harness.devtrace import DevEvents, busy_intervals
    from portbench.harness.serving import Span
    ev = DevEvents(["k_a", "k_b", "paged_split<x>", "k_a"],
                   np.array([0.0, 0.5, 2.0, 2.5]),
                   np.array([1.0, 0.8, 3.0, 2.6]))
    a, b = busy_intervals(ev, 0.0, 4.0)
    assert a.tolist() == [0.0, 2.0] and b.tolist() == [1.0, 3.0]
    ctx = layers.Context(spans=[], traced_spans=[Span("decode_batch", 0.9,
                                                      2.1)],
                         t0=0.0, t1=0.0, cfg={}, ref=None, events=ev,
                         trace=(0.0, 4.0))
    assert ctx.busy_s() == 2.0
    assert ctx.kernel_s("paged_split") == 1.0
    assert layers.load("device_idle").read(ctx) == 50.0
    br = layers.breakdown(ctx)
    assert br["device_ops"][0] == ["k_a", 1.1]
    assert dict(br["idle_gaps"]) == {"decode_batch": 1.0, "loop": 1.0}
