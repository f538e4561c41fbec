"""The disk medium bypasses the page cache (``core/transfer.py``):
``DiskPath.store`` drops the file's pages right after its fsync, round
trips stay bit-exact for a dense KV payload and a recurrent state
payload, the file is gone after ``fetch``, a platform without
``posix_fadvise`` raises, and ``mount_of`` names the filesystem that
holds the scratch directory. CPU only."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import transfer  # noqa: E402
from repro_torch.core.transfer import DiskPath, map_tensors, mount_of  # noqa: E402


def _kv_payload(dtype):
    rng = np.random.default_rng(0)
    k, v = (torch.from_numpy(rng.standard_normal((4, 37, 2, 16))
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    return (3, k, v, torch.from_numpy(rng.standard_normal((1, 50))
                                      .astype(np.float32)))


def _state_payload():
    rng = np.random.default_rng(1)
    wkv = torch.from_numpy(rng.standard_normal((2, 1, 4, 16, 16))
                           .astype(np.float32))
    shift = torch.from_numpy(rng.standard_normal((2, 1, 64))
                             .astype(np.float32)).bfloat16()
    return ((wkv, shift), torch.zeros(1, 50))


def _flat(payload):
    out = []
    map_tensors(out.append, payload)
    return out


@pytest.mark.parametrize("payload", [
    _kv_payload(torch.bfloat16), _kv_payload(torch.float32),
    _state_payload()], ids=["kv-bf16", "kv-f32", "recurrent-state"])
def test_disk_round_trip_is_bit_exact_and_removes_the_file(tmp_path,
                                                           payload):
    path = DiskPath(scratch_dir=str(tmp_path))
    handle = path.store(payload)
    assert os.path.exists(handle[0])
    back = path.fetch(handle)
    assert not os.path.exists(handle[0])
    assert os.listdir(tmp_path) == []
    want, got = _flat(payload), _flat(back)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert type(back) is type(payload)


def test_store_drops_the_pages_after_the_fsync(tmp_path, monkeypatch):
    calls = []
    real_fsync, real_fadvise = os.fsync, os.posix_fadvise

    def fsync(fd):
        calls.append(("fsync", fd))
        return real_fsync(fd)

    def fadvise(fd, offset, length, advice):
        calls.append(("fadvise", fd, offset, length, advice,
                      os.fstat(fd).st_size))
        return real_fadvise(fd, offset, length, advice)
    monkeypatch.setattr(transfer.os, "fsync", fsync)
    monkeypatch.setattr(transfer.os, "posix_fadvise", fadvise)
    path = DiskPath(scratch_dir=str(tmp_path))
    handle = path.store(_kv_payload(torch.bfloat16))
    assert [c[0] for c in calls] == ["fsync", "fadvise"]
    (_, fd_sync), (_, fd, offset, length, advice, size) = calls
    assert fd == fd_sync
    assert (offset, length, advice) == (0, 0, os.POSIX_FADV_DONTNEED)
    assert size == os.path.getsize(handle[0]) > 0   # the whole file, written
    path.fetch(handle)


def test_store_raises_without_posix_fadvise(tmp_path, monkeypatch):
    monkeypatch.delattr(transfer.os, "posix_fadvise")
    path = DiskPath(scratch_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="posix_fadvise"):
        path.store(_kv_payload(torch.float32))
    assert os.listdir(tmp_path) == []          # nothing was written
    path.store_cost(1 << 20)                   # the cost model needs none


def test_mount_of_takes_the_longest_prefix(tmp_path):
    mounts = tmp_path / "mounts"
    mounts.write_text(
        "rootfs / ext4 rw 0 0\n"
        "tmpfs /tmp tmpfs rw 0 0\n"
        "nvme /tmp/nv\\040me xfs rw 0 0\n"
        "other /tmpx ext4 rw 0 0\n")
    assert mount_of("/tmp/a/b", str(mounts)) == ("/tmp", "tmpfs")
    assert mount_of("/tmp", str(mounts)) == ("/tmp", "tmpfs")
    assert mount_of("/tmp/nv me/f.kv", str(mounts)) == ("/tmp/nv me", "xfs")
    assert mount_of("/tmpxy", str(mounts)) == ("/", "ext4")
    assert mount_of("/var", str(mounts)) == ("/", "ext4")


def test_mount_of_reads_this_machine(tmp_path):
    if not os.path.exists("/proc/mounts"):
        pytest.skip("no /proc/mounts on this platform")
    point, fstype = mount_of(str(tmp_path))
    assert str(tmp_path).startswith(point) and fstype != "unknown"
