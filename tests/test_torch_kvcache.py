"""The port's paged KV pool: the copied ``PagedKVPool`` hands out the
reference's block tables, and ``DevicePagedKV`` keeps bytes in torch
pages that round-trip and that paged attention reads like a dense
cache (the port of tests/test_kvcache.py's pool-vs-dense check)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.kvcache import OutOfPages, PagedKVPool  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_copy_gives_reference_block_tables(seed):
    rng = np.random.default_rng(seed)
    ref, port = PagedKVPool(64, page_size=8), tkv.PagedKVPool(64, page_size=8)
    live = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op < 2 or not live:
            sid, n = int(rng.integers(0, 20)), int(rng.integers(1, 40))
            outcome = []
            for pool, exc in ((ref, OutOfPages), (port, tkv.OutOfPages)):
                try:
                    outcome.append(pool.allocate(sid, n))
                except exc:
                    outcome.append("full")
            assert outcome[0] == outcome[1]
            if outcome[0] != "full" and sid not in live:
                live.append(sid)
        elif op == 2:
            sid = live.pop(int(rng.integers(0, len(live))))
            assert ref.free_seq(sid) == port.free_seq(sid)
        else:
            victim = ref.evict_lru()
            assert port.evict_lru() == victim
            if victim in live:
                live.remove(victim)
        assert {s: ref.block_table(s) for s in ref.seqs} == \
            {s: port.block_table(s) for s in port.seqs}
        assert ref.free == port.free
    port.check_invariants()


def test_device_pool_round_trip_and_free():
    L, KV, hd, page = 2, 2, 32, 16
    pool = tkv.PagedKVPool(num_pages=8, page_size=page)
    dev = tkv.DevicePagedKV(pool, L, KV, hd, dtype=torch.float32,
                            device="cpu")
    rng = np.random.default_rng(0)
    S = 40
    ks = torch.from_numpy(rng.standard_normal((L, S, KV, hd))
                          .astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((L, S, KV, hd))
                          .astype(np.float32))
    pool.allocate(3, 5)                  # another sequence owns page 0
    pool.allocate(7, S)
    dev.write_prefill(7, ks, vs)
    k_back, v_back = dev.gather_dense(7)
    assert torch.equal(k_back, ks) and torch.equal(v_back, vs)
    k_tok = torch.from_numpy(rng.standard_normal((L, KV, hd))
                             .astype(np.float32))
    pool.allocate(7, 1)
    dev.write_token(7, k_tok, -k_tok, S)
    k_back, v_back = dev.gather_dense(7)
    assert torch.equal(k_back[:, S], k_tok)
    assert torch.equal(v_back[:, S], -k_tok)
    assert torch.equal(k_back[:, :S], ks)
    # the copy does not alias the pool
    k_back.zero_()
    assert torch.equal(dev.gather_dense(7)[0][:, :S], ks)
    free_before = pool.free_pages
    assert dev.free(7) == 3 and pool.free_pages == free_before + 3
    assert not pool.has_seq(7) and dev.free(7) == 0


def test_paged_attention_over_pool_matches_dense():
    """Block-table attention over a real pool == dense attention over the
    gathered KV, in the port and against the reference's same check."""
    KV, hd, page, H = 2, 32, 16, 4
    pool = tkv.PagedKVPool(num_pages=16, page_size=page)
    dev = tkv.DevicePagedKV(pool, 1, KV, hd, dtype=torch.float32,
                            device="cpu")
    rng = np.random.default_rng(5)
    lens = [37, 52]
    for sid, S in enumerate(lens):
        pool.allocate(sid, S)
        dev.write_prefill(sid, *(torch.from_numpy(
            rng.standard_normal((1, S, KV, hd)).astype(np.float32))
            for _ in range(2)))
    max_pages = max(len(pool.block_table(s)) for s in (0, 1))
    bt = np.zeros((2, max_pages), np.int32)
    for sid in (0, 1):
        t = pool.block_table(sid)
        bt[sid, :len(t)] = t
    q = rng.standard_normal((2, H, hd)).astype(np.float32)
    out = t_ops.paged_attention(torch.from_numpy(q), dev.k[0], dev.v[0],
                                torch.from_numpy(bt),
                                torch.tensor(lens, dtype=torch.int32))
    from repro.kernels import ref
    want_ref = ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(dev.k[0].numpy()),
        jnp.asarray(dev.v[0].numpy()), jnp.asarray(bt),
        jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_ref), atol=2e-4)
    for sid, S in enumerate(lens):
        k_d, v_d = dev.gather_dense(sid)
        qg = torch.from_numpy(q[sid]).reshape(KV, H // KV, hd)
        probs = torch.softmax(torch.einsum("kgd,tkd->kgt", qg, k_d[0])
                              / np.sqrt(hd), dim=-1)
        want = torch.einsum("kgt,tkd->kgd", probs, v_d[0]).reshape(H, hd)
        torch.testing.assert_close(out[sid], want, atol=2e-4, rtol=2e-4)
