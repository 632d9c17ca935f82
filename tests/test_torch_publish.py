"""The port's live-weight publication against the JAX package: the delta
planner, records, the on-disk format in both directions, the applier and
the scheduler's verified chunk reads.

Every comparison is bitwise.  Planner cases mirror
``tests/test_publish.py:63-213`` (cold, chunked delta, un-keyed extents,
mixed, meta change, whole object, a ``shard_spec`` window, the non-slab
refusal): the same numpy-seeded records go through both packages'
``plan_delta``, ``leaf_window`` and ``build_record``.  A root written by
either package's ``Publisher.publish_state`` is followed by the other's
``Subscriber`` (f32 and bf16), and ``publish_snapshot`` of a port snapshot
(plain and ``cas=``) writes the JAX publisher's records.
"""

import asyncio
import dataclasses
import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.publish as jpub
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.publish as tpub
from torchsnapshot_tpu import scheduler as jsched
from torchsnapshot_tpu.storage.fs import FSStoragePlugin as JaxFS
from torchsnapshot_tpu_torch import scheduler
from torchsnapshot_tpu_torch.cas.store import chunk_key, chunk_location
from torchsnapshot_tpu_torch.io_types import ReadIO
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.utils.checksums import adler32_fast, crc32_fast

CHUNK = 1024
N = 4096  # float32: 16 chunks a leaf at CHUNK


def _keyed_ref(data):
    key = chunk_key((crc32_fast(data), adler32_fast(data), len(data)))
    return tpub.make_ref(key, 0, chunk_location(key))


def _chunked_leaf(arr, chunk=CHUNK):
    raw = arr.tobytes()
    return {
        "kind": "array",
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "size": len(raw),
        "refs": [_keyed_ref(raw[lo : lo + chunk]) for lo in range(0, len(raw), chunk)],
    }


def _extent_leaf(lo, hi):
    return {
        "kind": "array", "dtype": "float32", "shape": [(hi - lo) // 4], "size": hi - lo,
        "refs": [tpub.make_ref(None, 0, "objects/w", byte_range=[lo, hi], nbytes=hi - lo)],
    }


def _no_t(record):
    return {k: v for k, v in record.items() if k != "t"}


def _records(step, leaves, bases=("file:///base",)):
    """The record from both packages' ``build_record``, equal but for ``t``."""
    port = tpub.build_record(step, "test", list(bases), leaves)
    jax = jpub.build_record(step, "test", list(bases), leaves)
    assert _no_t(port) == _no_t(jax)
    return port


def _case(name, rng):
    """(new record, held record, shard_spec) of one planner case."""
    a = rng.standard_normal(N).astype(np.float32)
    if name == "cold":
        return _records(1, {"w": _chunked_leaf(a)}), None, None
    if name == "chunked_delta":
        b = a.copy()
        b[0], b[N - 1] = -1.0, -2.0
        return _records(2, {"w": _chunked_leaf(b)}), _records(1, {"w": _chunked_leaf(a)}), None
    if name == "unkeyed_extents":
        held = _records(1, {"w": _extent_leaf(0, 2048), "v": _extent_leaf(0, 1024)}, ("file:///snapA",))
        new = _records(2, {"w": _extent_leaf(0, 2048), "v": _extent_leaf(0, 1024)}, ("file:///snapB",))
        return new, held, None
    if name == "mixed":
        raw = a[:256].tobytes()
        keyed = {"kind": "array", "dtype": "float32", "shape": [256], "size": 1024,
                 "refs": [_keyed_ref(raw)]}
        return _records(2, {"w": keyed}), _records(1, {"w": _extent_leaf(0, 1024)}), None
    if name == "meta_change":
        held = _records(1, {"w": _chunked_leaf(a)})
        return _records(2, {"w": _chunked_leaf(a.astype(np.float64))}), held, None
    if name == "whole_object":
        leaf = {"kind": "array", "dtype": "float32", "shape": [64], "size": 256,
                "refs": [_keyed_ref(a[:64].tobytes())]}
        return _records(2, {"w": dict(leaf)}), _records(1, {"w": leaf}), None
    if name == "shard_window":
        full = a.reshape(16, 256)
        b = full.copy()
        b[5] += 1.0  # inside rows 4..8
        b[0] -= 1.0  # outside
        held = _records(1, {"w": _chunked_leaf(full)})
        return _records(2, {"w": _chunked_leaf(b)}), held, {"w": ((4, 0), (4, 256))}
    if name == "non_slab":
        return _records(1, {"w": _chunked_leaf(a.reshape(16, 256))}), None, {"w": ((0, 8), (16, 128))}
    raise AssertionError(name)


_CASES = ["cold", "chunked_delta", "unkeyed_extents", "mixed", "meta_change", "whole_object",
          "shard_window", "non_slab"]


@pytest.mark.parametrize("name", _CASES)
def test_plan_delta_and_leaf_window_equal_the_jax_planner(name):
    new, held, spec = _case(name, np.random.default_rng(_CASES.index(name)))
    if name == "non_slab":
        for pkg in (tpub, jpub):
            with pytest.raises(ValueError, match="dim-0 slab"):
                pkg.plan_delta(new, held, shard_spec=spec)
        return
    port = tpub.plan_delta(new, held, shard_spec=spec)
    jax = jpub.plan_delta(new, held, shard_spec=spec)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    for path, leaf in new["leaves"].items():
        s = (spec or {}).get(path)
        assert tpub.leaf_window(leaf, s) == jpub.leaf_window(leaf, s)
    expect = {
        "cold": (16, 16 * CHUNK), "chunked_delta": (2, 2 * CHUNK), "unkeyed_extents": (2, 3072),
        "mixed": (1, 1024), "meta_change": (32, 2 * N * 4), "whole_object": (0, 0),
        "shard_window": (1, CHUNK),
    }[name]
    assert (len(port.fetches), port.stats["bytes_fetch"]) == expect


def test_build_record_refusal_and_record_store_cross_read(tmp_path):
    """A record whose refs do not tile its leaf is refused by both; a
    record and HEAD written by either store are read by the other, and a
    flipped byte fails both."""
    bad = {"w": {"kind": "array", "dtype": "float32", "shape": [256], "size": 1024,
                 "refs": [tpub.make_ref(None, 0, "p", byte_range=[0, 512], nbytes=512)]}}
    for pkg in (tpub, jpub):
        with pytest.raises(ValueError, match="tile"):
            pkg.build_record(1, "test", ["file:///b"], bad)
    rec = _records(3, {"w": _chunked_leaf(np.arange(64, dtype=np.float32))})
    for writer, reader in ((tpub, jpub), (jpub, tpub)):
        root = str(tmp_path / writer.__name__)
        store = writer.PublishStore(root)
        assert store.read_head() is None
        path = store.write_record(rec)
        store.sync_close()
        other = reader.PublishStore(root)
        assert other.read_head()["step"] == 3 and other.read_record(path) == rec
        other.sync_close()
        blob = open(os.path.join(root, path), "rb").read()
        open(os.path.join(root, path), "wb").write(blob[:40] + bytes([blob[40] ^ 1]) + blob[41:])
        for pkg in (tpub, jpub):
            store = pkg.PublishStore(root)
            with pytest.raises(RuntimeError, match="checksum|corrupt"):
                store.read_record(path)
            store.sync_close()


def _arrays(seed, bf16):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 256)).astype(np.float32)
    b = rng.standard_normal(1000).astype(ml_dtypes.bfloat16 if bf16 else np.float32)
    return {"w": w, "b": b}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_root_followed_bitwise_by_the_other_package(tmp_path, writer):
    """Three steps (a sparse change each) published by one package are
    followed by the other's subscriber, f32 and bf16 leaves bitwise; both
    publishers write equal records and the same pool chunks."""
    roots = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    pubs = {"jax": jpub.Publisher(roots["jax"], chunk_size_bytes=CHUNK),
            "port": tpub.Publisher(roots["port"], chunk_size_bytes=CHUNK)}
    reader = "port" if writer == "jax" else "jax"
    zero = {k: np.zeros_like(v) for k, v in _arrays(0, True).items()}
    if reader == "port":
        live = {"app": tts.StateDict({k: _torch(v) for k, v in zero.items()})}
        sub = tpub.Subscriber(roots[writer], live, device="cpu")
    else:
        live = {"app": jts.StateDict(dict(zero))}
        sub = jpub.Subscriber(roots[writer], live)
    arrays = _arrays(0, True)
    try:
        for step in (1, 2, 3):
            if step > 1:
                arrays["w"][step] += 1.0
                arrays["b"][7 * step] = ml_dtypes.bfloat16(step)
            for pkg, pub in pubs.items():
                app = ({"app": tts.StateDict({k: _torch(v) for k, v in arrays.items()})} if pkg == "port"
                       else {"app": jts.StateDict({k: v.copy() for k, v in arrays.items()})})
                pub.publish_state(app, step)
            assert sub.poll_once() == step
            for k, v in arrays.items():
                assert _bytes(live["app"][k]) == _bytes(v), (step, k)
            recs = {}
            for pkg, pkg_mod in (("jax", jpub), ("port", tpub)):
                store = pkg_mod.PublishStore(roots[pkg])
                recs[pkg] = _no_t(store.read_record(store.read_head()["record"]))
                store.sync_close()
            assert {**recs["jax"], "bases": None} == {**recs["port"], "bases": None}
        if reader == "port":
            assert live["app"]["b"].dtype == torch.bfloat16
        pools = {pkg: sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                             for f in fs if "objects" in d) for pkg, root in roots.items()}
        assert pools["jax"] == pools["port"] and pools["port"]
    finally:
        sub.close()
        for pub in pubs.values():
            pub.close()


def test_root_rollup_equal_in_both_packages(tmp_path):
    root = str(tmp_path / "pub")
    pub = tpub.Publisher(root, chunk_size_bytes=CHUNK)
    live = {"app": tts.StateDict(w=torch.zeros(N))}
    sub = tpub.Subscriber(root, live, sub_id="sub-lag", device="cpu")
    try:
        pub.publish_state({"app": tts.StateDict(w=torch.arange(N, dtype=torch.float32))}, 1)
        sub.poll_once()
        pub.publish_state({"app": tts.StateDict(w=torch.arange(N, dtype=torch.float32) + 1)}, 2)
        rolls = [tpub.root_rollup(root), jpub.root_rollup(root)]
        for roll in rolls:
            for s in roll["subscribers"]:
                s.pop("age_s")
        assert rolls[0] == rolls[1]
        (entry,) = rolls[0]["subscribers"]
        assert entry["lag_steps"] == 1 and rolls[0]["step"] == 2
        assert tpub.root_rollup(str(tmp_path)) is None is jpub.root_rollup(str(tmp_path))
    finally:
        sub.close()
        pub.close()


@pytest.mark.parametrize("cas", [False, True])
def test_publish_snapshot_of_a_port_take_writes_the_jax_record(tmp_path, cas):
    """Slab members become un-keyed extent refs, whole objects keyed refs,
    a chunk store's tables keyed chunk refs, primitives inlined; a port
    subscriber follows the plain snapshot bitwise."""
    rng = np.random.default_rng(11)
    arrays = {f"small{i}": rng.standard_normal(40 + i).astype(np.float32) for i in range(3)}
    arrays["big"] = rng.standard_normal(1_400_000).astype(np.float32)
    state = {"app": tts.StateDict({k: torch.from_numpy(v) for k, v in arrays.items()}, step=7)}
    path = str(tmp_path / "snap")
    tts.Snapshot.take(path, state, **({"cas": {"chunk_size_bytes": 65536}} if cas else {}))
    recs = {}
    for pkg, mod in (("port", tpub), ("jax", jpub)):
        pub = mod.Publisher(str(tmp_path / f"pub_{pkg}"))
        pub.publish_snapshot(path, 5)
        pub.close()
        store = mod.PublishStore(str(tmp_path / f"pub_{pkg}"))
        recs[pkg] = _no_t(store.read_record(store.read_head()["record"]))
        store.sync_close()
    assert recs["port"] == recs["jax"]
    refs = {p: leaf["refs"] for p, leaf in recs["port"]["leaves"].items()}
    assert all(r["k"] for r in refs["app/big"])  # a whole object, or the pool's chunks
    assert cas or all(r["k"] is None and r["o"] for r in refs["app/small0"])  # a slab member
    assert recs["port"]["leaves"]["app/step"]["kind"] == "prim"
    live = {"app": tts.StateDict({k: torch.zeros(len(v)) for k, v in arrays.items()}, step=0)}
    sub = tpub.Subscriber(str(tmp_path / "pub_port"), live, device="cpu")
    if cas:
        # both publishers name a slab member of a chunk-store take by an
        # extent of the slab object, which lives only in the pool: neither
        # package's subscriber can fetch it (ROADMAP queue C)
        jsub = jpub.Subscriber(str(tmp_path / "pub_jax"),
                               {"app": jts.StateDict({k: np.zeros_like(v) for k, v in arrays.items()}, step=0)})
        for one in (sub, jsub):
            with pytest.raises(FileNotFoundError, match="batched"):
                one.poll_once()
            one.close()
        return
    try:
        assert sub.poll_once() == 1
    finally:
        sub.close()
    for k, v in arrays.items():
        assert _bytes(live["app"][k]) == v.tobytes(), k
    assert live["app"]["step"] == 7


def test_apply_decodes_what_the_jax_applier_decodes_where_the_live_leaf_is(tmp_path):
    """A windowed delta apply gives the JAX applier's bytes; leaves land
    on the live leaf's device and dtype: an ``nn.Module``'s parameters are
    copied into (the same objects), a ``StateDict`` value is replaced, a
    numpy leaf stays numpy, and a card-resident basis would be counted."""
    full = np.random.default_rng(3).standard_normal((16, 256)).astype(np.float32)
    root = str(tmp_path / "pub")
    pub = jpub.Publisher(root, chunk_size_bytes=CHUNK)
    spec = {"app/w": ((4, 0), (8, 256))}
    jlive = {"app": jts.StateDict(w=np.zeros((8, 256), np.float32), n=np.zeros(3, np.int64))}
    tlive = {"app": tts.StateDict(w=torch.zeros(8, 256), n=np.zeros(3, np.int64))}
    subs = [jpub.Subscriber(root, jlive, shard_spec=spec),
            tpub.Subscriber(root, tlive, shard_spec=spec, device="cpu")]
    try:
        for step in (1, 2):
            full[5 + step] += 1.0
            pub.publish_state({"app": jts.StateDict(w=full.copy(), n=np.arange(3) + step)}, step)
            for sub in subs:
                assert sub.poll_once() == step
            assert _bytes(tlive["app"]["w"]) == _bytes(jlive["app"]["w"]) == full[4:12].tobytes()
            assert isinstance(tlive["app"]["n"], np.ndarray)
            assert np.array_equal(tlive["app"]["n"], jlive["app"]["n"])
        assert subs[1].live.basis_copies == 0  # CPU leaves: no device copy
    finally:
        for sub in subs:
            sub.close()
        pub.close()
    # an nn.Module keeps its parameter objects; a bf16 live leaf stays bf16
    model = torch.nn.Linear(8, 4).to(torch.bfloat16)
    params = [model.weight, model.bias]
    src = torch.nn.Linear(8, 4).to(torch.bfloat16)
    pub = tpub.Publisher(str(tmp_path / "m"), chunk_size_bytes=64)
    sub = tpub.Subscriber(str(tmp_path / "m"), {"m": model}, device="cpu")
    try:
        pub.publish_state({"m": src}, 1)
        assert sub.poll_once() == 1
    finally:
        sub.close()
        pub.close()
    assert model.weight is params[0] and model.bias is params[1]
    assert model.weight.dtype == torch.bfloat16 and torch.equal(model.weight, src.weight)


class _SlowFS(FSStoragePlugin):
    """Reads of ``slow`` take 0.5 s; records the order reads start in and
    the bytes in flight."""

    def __init__(self, root, slow=()):
        super().__init__(root)
        self.order, self.slow = [], set(slow)
        self.inflight = self.peak = 0

    async def read(self, read_io: ReadIO) -> None:
        self.order.append(read_io.path)
        n = read_io.byte_range[1] - read_io.byte_range[0] if read_io.byte_range else 1024
        self.inflight += n
        self.peak = max(self.peak, self.inflight)
        try:
            if read_io.path in self.slow:
                await asyncio.sleep(0.5)
            await super().read(read_io)
        finally:
            self.inflight -= n


def test_chunk_reads_priority_budget_fail_closed_and_deadline(tmp_path, monkeypatch):
    """Results in submission order equal to the JAX engine's; lower
    priority classes start first (one read in flight); the budget bounds
    the bytes in flight; a flipped byte fails closed in both; a read not
    admitted within ``CHUNK_READ_ADMISSION_DEADLINE_S`` raises naming its
    path."""
    rng = np.random.default_rng(5)
    items = []
    for i in range(6):
        data = rng.bytes(1024)
        (tmp_path / f"c{i}").write_bytes(data)
        key = chunk_key((crc32_fast(data), adler32_fast(data), 1024))
        items.append((f"c{i}", None, key, 1024))
    (tmp_path / "slab").write_bytes(rng.bytes(4096))
    items.append(("slab", (1000, 3000), None, 2000))
    prios = [2, 0, 1, 0, 2, 1, 0]
    storage = _SlowFS(str(tmp_path))
    with monkeypatch.context() as m:
        m.setenv("TORCHSNAPSHOT_TPU_TORCH_MAX_PER_RANK_IO_CONCURRENCY", "1")
        got = scheduler.sync_execute_chunk_reads(items, storage, 1 << 20, priorities=prios)
    want = jsched.sync_execute_chunk_reads(items, JaxFS(str(tmp_path)), 1 << 20, priorities=prios)
    assert got == want
    assert storage.order == ["c1", "c3", "slab", "c2", "c5", "c0", "c4"]
    storage = _SlowFS(str(tmp_path))
    scheduler.sync_execute_chunk_reads(items, storage, 2048)
    assert storage.peak <= 2048
    blob = bytearray((tmp_path / "c2").read_bytes())
    blob[9] ^= 1
    (tmp_path / "c2").write_bytes(bytes(blob))
    with pytest.raises(IOError, match="content check"):
        scheduler.sync_execute_chunk_reads(items, FSStoragePlugin(str(tmp_path)), 1 << 20)
    with pytest.raises(IOError, match="content check"):
        jsched.sync_execute_chunk_reads(items, JaxFS(str(tmp_path)), 1 << 20)
    monkeypatch.setattr(scheduler, "CHUNK_READ_ADMISSION_DEADLINE_S", 0.1)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="'c1'"):
        scheduler.sync_execute_chunk_reads(items[:2], _SlowFS(str(tmp_path), slow={"c0"}), 1024)
    assert time.monotonic() - t0 < 5
