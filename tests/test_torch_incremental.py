"""Incremental takes (``take(base=)``) in the port, held against the JAX
package's on the same seeded state (after ``tests/test_incremental.py``).

An object whose (crc32, adler32, size) equals the base's object at the
same location is hardlinked from the base instead of written.  Both
packages lay the same state out alike, so the same locations are linked
in both; the snapshots restore bitwise in either package, and the JAX
package's ``verify_snapshot`` finds the port's ``ok`` and ``complete``.
Byte comparisons are exact (tolerance 0: this path does no arithmetic).
"""

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin as TorchFS
from torchsnapshot_tpu_torch.test_utils import run_multiprocess

_WORKER_TIMEOUT_S = 90


def _state(seed, bump=0.0):
    """A frozen array, a hot array (changed by ``bump``) and two small
    ones that share a slab when batching is on."""
    rng = np.random.default_rng(seed)
    return {
        "frozen": rng.standard_normal(4096),
        "hot": rng.standard_normal(4096).astype(np.float32) + np.float32(bump),
        "a": rng.standard_normal(512).astype(np.float32),
        "b": rng.integers(-1000, 1000, 256).astype(np.int64),
    }


def _take(pkg, path, state, base=None, asynchronous=False):
    if pkg == "port":
        app = {"app": tts.StateDict({k: torch.from_numpy(v.copy()) for k, v in state.items()})}
        if asynchronous:
            return tts.Snapshot.async_take(path, app, base=base).wait()
        return tts.Snapshot.take(path, app, base=base)
    return jts.Snapshot.take(path, {"app": jts.StateDict(dict(state))}, base=base)


def _linked(root, a, b):
    """Locations of snapshot ``b`` that are hardlinks of ``a``'s files."""
    out = set()
    for dirpath, _, files in os.walk(os.path.join(root, b)):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), os.path.join(root, b))
            other = os.path.join(root, a, rel)
            if os.path.exists(other) and os.stat(other).st_ino == os.stat(os.path.join(dirpath, f)).st_ino:
                out.add(rel)
    return out


def _restored(pkg, path, like):
    """``path`` restored by ``pkg`` into zeroed templates, as numpy."""
    if pkg == "port":
        dest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in like.items()})
        tts.Snapshot(path).restore({"app": dest}, device="cpu")
        return {k: t.numpy() for k, t in dest.items()}
    dest = jts.StateDict({k: np.zeros_like(v) for k, v in like.items()})
    jts.Snapshot(path).restore({"app": dest})
    return dict(dest)


def _assert_bitwise(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("batching", [True, False], ids=["slabs", "no_slabs"])
@pytest.mark.parametrize("asynchronous", [False, True], ids=["take", "async_take"])
def test_unchanged_objects_are_linked_as_in_jax(tmp_path, batching, asynchronous):
    s1, s2 = _state(0), _state(0, bump=1.0)
    linked = {}
    for pkg in ("port", "jax"):
        root = str(tmp_path / pkg)
        # a 4 KiB slab threshold: "a" and "b" share a slab, the others
        # stand alone
        with jknobs.override_disable_batching(not batching), tknobs.override_disable_batching(not batching), \
                jknobs.override_slab_size_threshold_bytes(4096), tknobs.override_slab_size_threshold_bytes(4096):
            tts.obs.reset_metrics()
            _take(pkg, f"{root}/s1", s1)
            _take(pkg, f"{root}/s2", s2, base=f"{root}/s1", asynchronous=asynchronous and pkg == "port")
        if pkg == "port":
            deduped = tts.obs.counters().get(tts.obs.BYTES_DEDUPED, 0)
        linked[pkg] = _linked(root, "s1", "s2") - {".snapshot_obsrecord"}
    assert linked["port"] == linked["jax"]
    assert len(linked["port"]) == (2 if batching else 3)
    # the linked bytes are counted, and only they
    port_md = tts.Snapshot(str(tmp_path / "port" / "s2")).metadata
    assert deduped == sum(port_md.objects[loc][2] for loc in linked["port"])
    # the same objects table (digests and sizes) in both packages
    assert port_md.objects == jts.Snapshot(str(tmp_path / "jax" / "s2")).metadata.objects
    for pkg in ("port", "jax"):
        _assert_bitwise(_restored(pkg, str(tmp_path / "port" / "s2"), s2), s2)
    res = jts.verify_snapshot(jts.Snapshot(str(tmp_path / "port" / "s2")), deep=True)
    assert res.ok and res.complete, str(res)
    assert tts.Snapshot(str(tmp_path / "port" / "s2")).verify(deep=True).ok


@pytest.mark.parametrize("base_pkg", ["port", "jax"])
def test_snapshot_survives_deleting_its_base(tmp_path, base_pkg):
    """The base is taken by either package and deleted by the port; the
    port's incremental snapshot still restores and verifies in both."""
    state = _state(1)
    with jknobs.override_disable_batching(True), tknobs.override_disable_batching(True):
        _take(base_pkg, str(tmp_path / "s1"), state)
        _take("port", str(tmp_path / "s2"), state, base=str(tmp_path / "s1"))
    assert _linked(str(tmp_path), "s1", "s2") >= {"0/app/frozen", "0/app/hot"}
    tts.delete_snapshot(str(tmp_path / "s1"))
    assert not os.path.exists(tmp_path / "s1")
    for pkg in ("port", "jax"):
        _assert_bitwise(_restored(pkg, str(tmp_path / "s2"), state), state)
    assert tts.verify_snapshot(str(tmp_path / "s2"), deep=True).ok
    assert jts.verify_snapshot(str(tmp_path / "s2"), deep=True).ok


def test_objects_table_and_chained_links(tmp_path):
    """The committed objects table equals the JAX package's, entry for
    entry ([crc32, adler32, size], the size the file's); a chain
    s1 ← s2 ← s3 leaves s3's objects on s1's inodes."""
    state = _state(2)
    for pkg in ("port", "jax"):
        root = tmp_path / pkg
        _take(pkg, str(root / "s1"), state)
        _take(pkg, str(root / "s2"), state, base=str(root / "s1"))
        _take(pkg, str(root / "s3"), state, base=str(root / "s2"))
    port_md = tts.Snapshot(str(tmp_path / "port" / "s3")).metadata
    assert port_md.objects == jts.Snapshot(str(tmp_path / "jax" / "s3")).metadata.objects
    for loc, rec in port_md.objects.items():
        assert len(rec) == 3 and rec[2] == os.path.getsize(tmp_path / "port" / "s3" / loc)
        assert os.stat(tmp_path / "port" / "s3" / loc).st_ino == os.stat(tmp_path / "port" / "s1" / loc).st_ino


@pytest.mark.parametrize("case", ["checksums_off", "bogus_base", "base_is_target", "base_encoded"])
def test_unusable_base_gives_a_full_save(tmp_path, case, caplog):
    """WRITE_CHECKSUMS=0, a base that does not exist and the base equal to
    the target each give a full save: nothing is linked.  A base whose
    objects are stored encoded (zlib frames) is usable: every object is
    linked and its frame table carried verbatim, as the JAX package does.
    Either way the snapshot restores bitwise in both packages."""
    state = _state(3)
    target = tmp_path / ("s1" if case == "base_is_target" else "s2")
    base = str(tmp_path / ("missing" if case == "bogus_base" else "s1"))
    with jknobs.override_disable_batching(True), tknobs.override_disable_batching(True), \
            tknobs.override_write_checksums(case != "checksums_off"):
        with tknobs.override_codec("zlib" if case == "base_encoded" else "raw"):
            _take("port", str(tmp_path / "s1"), state)
        _take("port", str(target), state, base=base)
    if case == "base_encoded":
        base_md = tts.Snapshot(str(tmp_path / "s1")).metadata
        assert base_md.codecs and set(base_md.codecs) == set(base_md.objects)
        assert _linked(str(tmp_path), "s1", "s2") == set(base_md.objects)
        assert tts.Snapshot(str(target)).metadata.codecs == base_md.codecs
        assert tts.verify_snapshot(str(target), deep=True).ok
    elif case != "base_is_target":
        assert not _linked(str(tmp_path), "s1", target.name)
    if case in ("checksums_off", "bogus_base", "base_is_target"):
        assert "full save" in caplog.text
    for pkg in ("port", "jax"):
        _assert_bitwise(_restored(pkg, str(target), state), state)


def test_failed_link_falls_back_to_a_write(tmp_path, monkeypatch):
    state = _state(4)
    with tknobs.override_disable_batching(True):
        _take("port", str(tmp_path / "s1"), state)

        async def refuse(self, base_url, path):
            raise RuntimeError("backend refused the link")

        monkeypatch.setattr(TorchFS, "link_from", refuse)
        tts.obs.reset_metrics()
        _take("port", str(tmp_path / "s2"), state, base=str(tmp_path / "s1"))
    assert not _linked(str(tmp_path), "s1", "s2")
    assert tts.obs.counters().get(tts.obs.BYTES_DEDUPED, 0) == 0
    _assert_bitwise(_restored("jax", str(tmp_path / "s2"), state), state)
    assert tts.verify_snapshot(str(tmp_path / "s2"), deep=True).ok


def test_later_write_never_changes_the_base(tmp_path):
    """Re-taking the base in place with other content leaves the linked
    snapshot's bytes as they were: writes land on a temp name and
    replace the directory entry, never the shared inode."""
    state = _state(5)
    with tknobs.override_disable_batching(True):
        _take("port", str(tmp_path / "s1"), state)
        _take("port", str(tmp_path / "s2"), state, base=str(tmp_path / "s1"))
        changed = {k: v * 2 for k, v in state.items()}
        _take("port", str(tmp_path / "s1"), changed)
    for pkg in ("port", "jax"):
        _assert_bitwise(_restored(pkg, str(tmp_path / "s2"), state), state)
        _assert_bitwise(_restored(pkg, str(tmp_path / "s1"), state), changed)
    assert jts.verify_snapshot(str(tmp_path / "s2"), deep=True).ok


def test_two_rank_incremental_save(tmp_path):
    """Two ranks in subprocesses over a FileCoordinator (every wait with
    the launcher's deadline): rank 0 reads the base's objects table and
    broadcasts it, each rank links its own unchanged objects, and the
    JAX package verifies both ranks' views deeply."""
    body = """
    from torchsnapshot_tpu_torch import knobs
    with knobs.override_disable_batching(True):
        for n, hot in ((1, 0.0), (2, 1.0)):
            state = tts.StateDict(mine=torch.full((2048,), float(rank), dtype=torch.float64),
                                  hot=torch.full((64,), hot + rank, dtype=torch.float64))
            tts.Snapshot.take(snap_dir + f"/s{n}", {"app": state}, coordinator=coord,
                              base=snap_dir + "/s1" if n == 2 else None)
    """
    run_multiprocess(tmp_path, 2, body, timeout_s=_WORKER_TIMEOUT_S)
    root = str(tmp_path / "snap")
    man1 = jts.Snapshot(f"{root}/s1").get_manifest()
    man2 = jts.Snapshot(f"{root}/s2").get_manifest()
    linked = _linked(root, "s1", "s2")
    for r in (0, 1):
        assert man2[f"{r}/app/mine"].location in linked
        assert man2[f"{r}/app/hot"].location not in linked
        assert man1[f"{r}/app/mine"].location == man2[f"{r}/app/mine"].location
        res = jts.verify_snapshot(jts.Snapshot(f"{root}/s2"), deep=True, rank=r)
        assert res.ok and res.complete, (r, str(res))
        for path in (f"{r}/app/mine", f"{r}/app/hot"):
            got = tts.Snapshot(f"{root}/s2").read_object(path, device="cpu").numpy()
            assert got.tobytes() == np.asarray(jts.Snapshot(f"{root}/s2").read_object(path)).tobytes()
        assert got[0] == 1.0 + r
