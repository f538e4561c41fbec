"""The port's collectives (``repro_torch.dist.collectives``) in a 4-rank
gloo group on the CPU, against analytic results.

The reference's own tests of these (``tests/test_collectives.py``) are
red under this JAX, so the port is held to the properties they check:
``compressed_psum`` within 2% of the mean, 50 error-feedback steps within
1% of the true sum, ``bucketed_psum`` within 1e-5 of the plain sum with
the buckets cut where the reference's rule cuts them, ``halo_exchange``
and ``ring_allgather`` exact. The ranks run in spawned processes under a
time limit, so a hang fails the test instead of the suite's clock.
"""
import json
import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C

    torch.set_num_threads(1)     # tiny shapes: no intra-op threads
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        rng = np.random.default_rng(0)          # the same data on every rank
        grads = {"a": rng.standard_normal((WORLD, 64)).astype(np.float32),
                 "b": rng.standard_normal((WORLD, 17)).astype(np.float32)}
        mine = {k: torch.from_numpy(v[rank].copy()) for k, v in grads.items()}
        res = {}

        # --- compressed all-reduce: mean within int8 tolerance ---------
        mean, err = C.compressed_psum(mine)
        res["compressed_rel_err"] = max(
            float((mean[k] - torch.from_numpy(v.mean(0))).abs().max()
                  / np.abs(v.mean(0)).max()) for k, v in grads.items())
        res["err_dtype"] = str(err["a"].dtype)

        # --- error feedback keeps 50 compressed steps unbiased ---------
        err, tot = None, {k: torch.zeros_like(v) for k, v in mine.items()}
        for _ in range(50):
            mean, err = C.compressed_psum(mine, err=err)
            tot = {k: tot[k] + mean[k] for k in tot}
        res["ef_rel_err"] = max(
            float((tot[k] - 50 * torch.from_numpy(v.mean(0))).abs().max()
                  / (50 * np.abs(v.mean(0)).max())) for k, v in grads.items())

        # --- bucketed sum == plain sum; the buckets and their types ----
        tree = {"a": mine["a"], "b": mine["b"],
                "c": torch.arange(8, dtype=torch.float64) * (rank + 1)}
        calls = []
        orig = dist.all_reduce

        def spy(t, *args, **kwargs):
            calls.append([t.numel(), str(t.dtype)])
            return orig(t, *args, **kwargs)
        dist.all_reduce = spy
        try:
            summed = C.bucketed_psum(tree, bucket_bytes=256)
        finally:
            dist.all_reduce = orig
        want = {"a": grads["a"].sum(0), "b": grads["b"].sum(0),
                "c": np.arange(8) * sum(range(1, WORLD + 1))}
        res["bucket_err"] = max(
            float((summed[k].double() - torch.from_numpy(
                np.asarray(want[k], np.float64))).abs().max())
            for k in want)
        res["bucket_calls"] = calls
        res["bucket_dtypes"] = {k: str(v.dtype) for k, v in summed.items()}

        # --- halo exchange: the left neighbour's tail, zeros at rank 0 --
        x = torch.arange(WORLD * 4 * 2, dtype=torch.float32).reshape(
            WORLD, 4, 2)
        h = C.halo_exchange(x[rank:rank + 1], halo=1, seq_axis=1)
        left = torch.zeros(2) if rank == 0 else x[rank - 1, -1]
        res["halo_ok"] = bool(torch.equal(h[0, 0], left)
                              and torch.equal(h[0, 1:], x[rank])
                              and tuple(h.shape) == (1, 5, 2))

        # --- ring pass and all-gather, in rank order -------------------
        v = torch.arange(WORLD, dtype=torch.float32).reshape(WORLD, 1)
        res["ring_pass_ok"] = bool(torch.equal(
            C.ring_pass(v[rank]), v[(rank - 1) % WORLD]))
        res["ring_ok"] = bool(torch.equal(
            C.ring_allgather(v[rank]), torch.arange(WORLD,
                                                    dtype=torch.float32)))
        # along one dim of a (2, 2) mesh: the row's two ranks, in order
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        row = rank // 2
        res["mesh_ring_ok"] = bool(torch.equal(
            C.ring_allgather(v[rank], mesh, "model"),
            torch.tensor([2.0 * row, 2.0 * row + 1])))
        with open(out_path, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each rank's results, from a 4-rank gloo group of spawned
    processes; a rank that does not finish in TIMEOUT_S fails."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    tmp = tmp_path_factory.mktemp("collectives")
    paths = [str(tmp / f"rank{r}.json") for r in range(WORLD)]
    procs = [ctx.Process(target=_worker, args=(r, port, paths[r]))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = []
    for path in paths:
        with open(path) as f:
            out.append(json.load(f))
    return out


def test_compressed_psum_close(results):
    for r in results:
        assert r["compressed_rel_err"] < 0.02        # int8 tolerance
        assert r["err_dtype"] == "torch.float32"


def test_error_feedback_unbiased(results):
    """50 accumulated compressed steps stay within 1% of the true sum."""
    for r in results:
        assert r["ef_rel_err"] < 0.01


def test_bucketed_psum_exact(results):
    """Within 1e-5 of the plain sum, in two buckets: 'a' (256 bytes)
    fills the first, 'b' (68) and 'c' (64) share the second, which is
    summed in float64 (the promotion of f32 and f64) and cast back."""
    for r in results:
        assert r["bucket_err"] < 1e-5
        assert r["bucket_calls"] == [[64, "torch.float32"],
                                     [25, "torch.float64"]]
        assert r["bucket_dtypes"] == {"a": "torch.float32",
                                      "b": "torch.float32",
                                      "c": "torch.float64"}


def test_halo_exchange(results):
    assert all(r["halo_ok"] for r in results)


def test_ring_allgather(results):
    for r in results:
        assert r["ring_pass_ok"] and r["ring_ok"] and r["mesh_ring_ok"]


def test_world_of_one():
    """In a world of one, ring_pass is the identity, the gather is the
    shard and the sums are the inputs."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert C.ring_pass(x) is x
        assert torch.equal(C.ring_allgather(x), x)
        assert torch.equal(C.halo_exchange(x, halo=1, seq_axis=1),
                           torch.cat([torch.zeros(2, 1), x], 1))
        assert torch.equal(C.bucketed_psum({"x": x})["x"], x)
        mean, err = C.compressed_psum({"x": x})
        torch.testing.assert_close(mean["x"] + err["x"], x)
    finally:
        dist.destroy_process_group()
