"""The port's payload transport (``transport/``) against the JAX
package's: the part plan, engine selection, local-mode publish, fetch and
cleanup, the KV engine's meter, refusals (a registry miss, a digest
mismatch), the KV blob's orphan sweep, blobs one package publishes and
the other fetches over one ``FileCoordinator`` directory, and a
two-process fan-out restore whose bytes move as gloo broadcasts of CPU
tensors on the session's own process group.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torchsnapshot_tpu.coordination as jcoord
from torchsnapshot_tpu.transport.collective import _plan_parts as jax_plan_parts
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs
from torchsnapshot_tpu_torch.coordination import FileCoordinator, LocalCoordinator
from torchsnapshot_tpu_torch.transport import (
    TransportUnavailable,
    current_engine,
    resolve_transport,
)
from torchsnapshot_tpu_torch.transport import collective as collective_mod
from torchsnapshot_tpu_torch.transport.collective import _plan_parts, _spans
from torchsnapshot_tpu_torch.transport.kv import KVTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counter(name):
    return obs.counters().get(name, 0)


def _payloads():
    rng = np.random.default_rng(42)
    return {
        "a": rng.integers(0, 256, size=70_001, dtype=np.uint8).tobytes(),
        "b": b"x" * 128,
        "c": rng.integers(0, 256, size=13, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


def _collective(coord):
    with tknobs.override_transport("collective"):
        return resolve_transport(coord, device="cpu")


def test_part_plan_matches_jax_part_count():
    """The port's parts: the JAX package's count, without the 128-byte
    lane padding (each part at most the JAX padded size, less than a lane
    short of it), covering every byte once."""
    for nbytes in (0, 1, 3, 127, 128, 129, 4096, 8191, 100_001, 10 << 20):
        for part_bytes in (200, 4096, 1 << 20, 8 << 20):
            nparts, base = _plan_parts(nbytes, part_bytes)
            jparts, ppad = jax_plan_parts(nbytes, part_bytes)
            assert nparts == jparts and base <= ppad and ppad - base < 128, (nbytes, part_bytes)
            spans = _spans(nbytes, nparts, base)
            assert spans[0][0] == 0 and spans[-1][1] == nbytes
            assert all(a == b for (_, a), (b, _) in zip(spans, spans[1:]))


def test_engine_selection():
    """``kv`` short-circuits; ``auto`` on one process is KV with no
    fallback counted; a forced ``collective`` runs in local mode; a
    forced ``collective`` that cannot run (payloads on a card this box
    lacks) lands on KV with one fallback counted."""
    coord = LocalCoordinator()
    with tknobs.override_transport("kv"):
        t = resolve_transport(coord, device="cpu")
    assert t.engine == "kv" and current_engine() == "kv"
    before = _counter(obs.TRANSPORT_FALLBACKS)
    with tknobs.override_transport("auto"):
        t = resolve_transport(coord, device="cpu")
    assert t.engine == "kv" and _counter(obs.TRANSPORT_FALLBACKS) == before
    t = _collective(coord)
    assert t.engine == "collective" and t.mode == "local" and current_engine() == "collective"
    t.close()
    if not torch.cuda.is_available():
        with tknobs.override_transport("collective"):
            t = resolve_transport(coord, device="cuda")
        assert t.engine == "kv" and _counter(obs.TRANSPORT_FALLBACKS) == before + 1


def test_collective_local_publish_fetch_bitwise_and_cleanup():
    coord = LocalCoordinator()
    t = _collective(coord)
    ops0 = _counter(obs.TRANSPORT_COLLECTIVE_OPS)
    try:
        with tknobs.override_transport_part_bytes(16384):
            for name, data in _payloads().items():
                assert t.publish(f"x/{name}", data) >= 1
                assert t.try_fetch(f"x/{name}") == data
        assert _counter(obs.TRANSPORT_COLLECTIVE_OPS) >= ops0 + 2 * len(_payloads())
        for name in _payloads():
            t.cleanup(f"x/{name}", 8)
            assert t.try_fetch(f"x/{name}") is None
        assert collective_mod._REGISTRY == {}
    finally:
        t.close()


def test_kv_transport_publish_fetch_bitwise_and_metered():
    coord = LocalCoordinator()
    t = KVTransport(coord)
    ops0, bytes0 = _counter(obs.TRANSPORT_KV_OPS), _counter(obs.TRANSPORT_KV_BYTES)
    for name, data in _payloads().items():
        t.publish(f"x/{name}", data)
        assert t.try_fetch(f"x/{name}") == data
    assert _counter(obs.TRANSPORT_KV_OPS) >= ops0 + 2 * len(_payloads())
    assert _counter(obs.TRANSPORT_KV_BYTES) >= bytes0 + 2 * sum(map(len, _payloads().values()))
    t.cleanup("x/a", 64)
    assert t.try_fetch("x/a") is None


def test_collective_refuses_a_registry_miss_and_a_digest_mismatch():
    """An announce whose parts another process holds is
    ``TransportUnavailable`` (the caller's KV ladder takes over); a
    payload that fails its digest raises ``ValueError``."""
    coord = LocalCoordinator()
    t = _collective(coord)
    try:
        t.publish("x/m", b"payload-bytes")
        with collective_mod._registry_lock:
            collective_mod._REGISTRY.pop("x/m")
        with pytest.raises(TransportUnavailable):
            t.try_fetch("x/m")
        t.publish("x/d", b"trust-but-verify")
        nparts, base, n, _crc, adler = coord.kv_try_get("x/d/xmeta").split(":")
        coord.kv_set("x/d/xmeta", f"{nparts}:{base}:{n}:12345:{adler}")
        with pytest.raises(ValueError):
            t.try_fetch("x/d")
    finally:
        t.close()


def test_kv_blob_orphan_sweep_and_meta_first_delete():
    """A reused prefix's leftover parts are swept after the new meta key
    (``transport.swept_parts``); a full sweep deletes the meta key
    first.  The JAX package's coordinator leaves the same keys."""
    for make in (LocalCoordinator, jcoord.LocalCoordinator):
        coord = make()
        coord.kv_publish_blob("fan/reuse", b"A" * 4000, part_bytes=1000)
        coord.kv_try_delete("fan/reuse/meta")  # a publisher killed mid-cleanup
        coord.kv_publish_blob("fan/reuse", b"B" * 1500, part_bytes=1000)
        assert sorted(coord._kv) == ["fan/reuse/meta", "fan/reuse/p0", "fan/reuse/p1"]
        assert coord.kv_try_fetch_blob("fan/reuse", timeout_s=1.0) == b"B" * 1500
        assert coord.kv_sweep_blob("fan/reuse") == 2
        assert coord._kv == {}
    swept0 = _counter(obs.TRANSPORT_SWEPT_PARTS)
    coord = LocalCoordinator()
    coord.kv_publish_blob("fan/x", b"C" * 2500, part_bytes=1000)
    coord.kv_try_delete("fan/x/meta")
    coord.kv_publish_blob("fan/x", b"D", part_bytes=1000)
    assert _counter(obs.TRANSPORT_SWEPT_PARTS) == swept0 + 2


def test_blobs_cross_packages_over_one_file_coordinator(tmp_path):
    """A blob the port publishes is fetched by the JAX package's
    coordinator over the same directory, and the reverse; a part
    replaced by another fails the crc32 in both."""
    kv = str(tmp_path / "kv")
    port, jax = FileCoordinator(kv, 0, 2), jcoord.FileCoordinator(kv, 1, 2)
    data = np.random.default_rng(3).integers(0, 256, 10_001, dtype=np.uint8).tobytes()
    for pub, fetch, prefix in ((port, jax, "fan/p2j"), (jax, port, "fan/j2p")):
        assert pub.kv_publish_blob(prefix, data, 4096) == len(data)
        assert fetch.kv_try_fetch_blob(prefix, timeout_s=1.0) == data
        pub.kv_set(f"{prefix}/p2", pub.kv_try_get(f"{prefix}/p1"))
        for c in (port, jax):
            with pytest.raises(ValueError, match="digest"):
                c.kv_try_fetch_blob(prefix, timeout_s=1.0)
        fetch.kv_sweep_blob(prefix)
        assert pub.kv_try_fetch_blob(prefix, timeout_s=1.0) is None


def test_kv_watch_returns_a_changed_value_or_none_like_jax(tmp_path):
    """``kv_watch`` gives a value that exists and differs from ``last``,
    None past its deadline (absent or unchanged), and None when the probe
    itself fails, as the JAX package's does."""
    import threading

    from torchsnapshot_tpu_torch.coordination import kv_watch

    class Broken(LocalCoordinator):
        def kv_try_get(self, key):
            raise OSError("announce channel down")

    kv = str(tmp_path / "kv")
    for watch, coord in ((kv_watch, FileCoordinator(kv, 0, 1)), (jcoord.kv_watch, jcoord.FileCoordinator(kv, 0, 1))):
        coord.kv_try_delete("pub/head")
        assert watch(coord, "pub/head", timeout_s=0.05) is None
        coord.kv_set("pub/head", "3")
        assert watch(coord, "pub/head", last=None) == "3"
        assert watch(coord, "pub/head", last="3", timeout_s=0.05) is None
        t = threading.Timer(0.1, coord.kv_set, ("pub/head", "4"))
        t.start()
        assert watch(coord, "pub/head", last="3", timeout_s=5.0) == "4"
        t.join(5.0)
        assert not t.is_alive()
    assert kv_watch(Broken(), "pub/head", timeout_s=1.0) is None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GLOO_WORKER = """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.transport import current_engine
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    coord = tts.get_default_coordinator()
    K, N = 3, 100_000
    state = tts.StateDict(**{{f"w{{i}}": torch.arange(N, dtype=torch.float32) * (i + 1) for i in range(K)}})
    tts.Snapshot.take({snap!r}, {{"m": state}}, replicated=["**"], coordinator=coord)
    got = tts.StateDict(**{{f"w{{i}}": torch.zeros(N) for i in range(K)}})
    tts.Snapshot({snap!r}, coordinator=coord).restore({{"m": got}}, device="cpu")
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    c = tts.obs.counters()
    print("RESULT " + json.dumps({{
        "engine": current_engine(),
        "collective_ops": c.get("transport.collective_ops", 0),
        "collective_bytes": c.get("transport.collective_bytes", 0),
        "fallbacks": c.get("transport.fallbacks", 0),
        "fanout_fallbacks": c.get("topology.fanout_fallbacks", 0),
        "durable": c.get("topology.fanout_durable_reads", 0),
        "saved": c.get("topology.durable_gets_saved", 0),
    }}))
    dist.destroy_process_group()
"""


def test_two_process_collective_fanout_restore_over_gloo(tmp_path):
    """Two processes with a gloo default group, one slice of two hosts,
    ``TRANSPORT=collective``: every replicated object is read once for
    the slice and broadcast to the other rank as CPU tensors on the
    session's group (engine ``collective``, no fallback), bitwise."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_GLOO_WORKER.format(
        repo=REPO, port=_free_port(), snap=str(tmp_path / "snap"),
    )))
    env = {
        **os.environ,
        "TORCHSNAPSHOT_TPU_TORCH_TOPOLOGY": "0,0",
        "TORCHSNAPSHOT_TPU_TORCH_TRANSPORT": "collective",
        "TORCHSNAPSHOT_TPU_TORCH_DISABLE_BATCHING": "1",
        "TORCHSNAPSHOT_TPU_TORCH_TRANSPORT_TIMEOUT_S": "10",
    }
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), "2"], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=90)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    K, N = 3, 100_000
    for res in results:
        assert res["engine"] == "collective" and res["fallbacks"] == 0, res
        assert res["fanout_fallbacks"] == 0 and res["collective_ops"] == K, res
    assert sum(r["collective_bytes"] for r in results) == 2 * K * N * 4
    assert sum(r["durable"] for r in results) == K
    assert sum(r["saved"] for r in results) == K
