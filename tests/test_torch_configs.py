"""The port's config copies equal the reference's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_config_matches_reference(arch):
    ref, port = REGISTRY[arch], tcfg.REGISTRY[arch]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    small_ref, small = reduce_for_smoke(ref), tcfg.reduce_for_smoke(port)
    assert dataclasses.asdict(small) == dataclasses.asdict(small_ref)
    for a, b in ((port, ref), (small, small_ref)):
        assert a.kv_bytes_per_token() == b.kv_bytes_per_token()
        assert a.param_count() == b.param_count()


def test_registry_and_shapes_match():
    assert list(tcfg.REGISTRY) == list(REGISTRY)
    from repro.configs import SHAPES
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
