"""The port's real-mode streams under memory pressure: a pool of ~1.6
sequences forces colocated preemption and recompute (the eviction case
of tests/test_serving_integration.py), and every setup must still give
the reference's tokens."""
import pytest

pytest.importorskip("torch")

from test_torch_serving import (SETUPS, _streams, run_port,  # noqa: E402
                                run_reference)

POOL = int(54 * 1.6)
_RUNS = {}


def _runs():
    if not _RUNS:
        _RUNS["ref"] = _streams(run_reference("dis-host", 4, POOL))
        _RUNS["port"] = run_port(SETUPS, 4, POOL)
    return _RUNS


@pytest.mark.parametrize("setup", SETUPS)
def test_tokens_under_eviction_match_reference(setup):
    runs = _runs()
    assert _streams(runs["port"][setup]) == runs["ref"], setup


def test_eviction_happened():
    res = _runs()["port"]["co-1gpu"]
    assert res.metrics.total_evictions > 0
    assert any(r.recomputed_tokens > 0 for r in res.requests)
