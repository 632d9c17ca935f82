"""``python -m torchsnapshot_tpu_torch`` against ``python -m
torchsnapshot_tpu``: ``ls``, ``manifest``, ``verify``, ``steps``,
``delete``, ``stats``, ``doctor`` and ``cas`` print the same lines and
exit with the same codes on the same snapshot, root and chunk pool,
written by either package; ``trace --device cpu`` writes a Perfetto file
with the JAX CLI's read-path span names; ``convert`` in both directions
writes what the JAX CLI writes and refuses what it refuses.  The
commands the port lacks exit 1 naming their ROADMAP item.  One run
through a subprocess checks the module entry point itself.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.__main__ import main as jax_main
from torchsnapshot_tpu_torch.__main__ import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(pkg, step):
    rng = np.random.default_rng(step)
    arrays = {
        "w": rng.standard_normal((16, 4)).astype(np.float32),
        "ids": rng.integers(-1000, 1000, (5000,)).astype(np.int64),
        "e": np.zeros((0, 3), np.float32),
    }
    if pkg == "port":
        return {"app": tts.StateDict(step=step, name="run", **{k: torch.from_numpy(v) for k, v in arrays.items()})}
    return {"app": jts.StateDict(step=step, name="run", **arrays)}


def _run(main, argv, capsys):
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys):
    port = _run(port_main, argv, capsys)
    jax = _run(jax_main, argv, capsys)
    assert port == jax, (argv, port, jax)
    return port


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_ls_manifest_and_verify_print_what_jax_prints(tmp_path, taker, capsys):
    path = str(tmp_path / "s")
    (tts if taker == "port" else jts).Snapshot.take(path, _state(taker, 1))
    rc, out, _ = _both(["ls", path], capsys)
    assert rc == 0 and out.endswith("5 entries\n") and "0/app/ids" in out
    rc, out, _ = _both(["manifest", path], capsys)
    assert rc == 0 and '"world_size": 1' in out
    for argv in (["verify", path], ["verify", path, "--deep"], ["verify", path, "--rank", "0"]):
        rc, out, _ = _both(argv, capsys)
        assert rc == 0 and out.startswith("OK (")
    # one flipped byte: the deep audit fails, in both CLIs alike
    loc = jts.Snapshot(path).metadata.manifest["0/app/w"].location
    with open(os.path.join(path, loc), "r+b") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0x01]))
    rc, out, _ = _both(["verify", path, "--deep"], capsys)
    assert rc == 1 and out.startswith("FAILED corrupt=")
    rc, out, _ = _both(["verify", path], capsys)
    assert rc == 0
    os.remove(os.path.join(path, loc))
    rc, out, _ = _both(["verify", path], capsys)
    assert rc == 1 and out.startswith("FAILED missing=")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_steps_and_delete_print_what_jax_prints(tmp_path, writer, capsys):
    root = str(tmp_path / "run")
    rc, out, err = _both(["steps", root], capsys)
    assert rc == 0 and out == "" and err == "(no committed snapshots)\n"
    mgr = (tts if writer == "port" else jts).SnapshotManager(root)
    for step in (2, 5):
        mgr.save(_state(writer, step), step=step)
    rc, out, _ = _both(["steps", root], capsys)
    assert out == f"2\t{root}/step_0000000002\n5\t{root}/step_0000000005\n"
    rc, out, err = _both(["delete", mgr.path_for_step(2)], capsys)
    assert rc == 2 and err == "refusing to delete without --yes\n"
    assert os.path.exists(mgr.path_for_step(2))
    rc, out, _ = _run(port_main, ["delete", mgr.path_for_step(2), "--yes"], capsys)
    assert rc == 0 and out == f"deleted {mgr.path_for_step(2)}\n"
    assert not os.path.exists(mgr.path_for_step(2))
    assert _run(jax_main, ["steps", root], capsys)[1] == f"5\t{root}/step_0000000005\n"
    # a path that holds no snapshot: the same one-line error and code
    rc, out, err = _both(["verify", mgr.path_for_step(2)], capsys)
    assert rc == 1 and err.startswith("error: no .snapshot_metadata")
    rc, out, err = _both(["ls", mgr.path_for_step(2)], capsys)
    assert rc == 1


def test_unported_commands_name_their_roadmap_item(tmp_path, capsys):
    for cmd, item in (("lint", "8"),):
        rc, out, err = _run(port_main, [cmd, str(tmp_path), "--json"], capsys)
        assert rc == 1 and out == "" and f"queue A item {item}" in err, (cmd, err)


def test_module_entry_point_runs(tmp_path):
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, _state("port", 3))
    proc = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", "verify", path, "--deep"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.startswith("OK ("), proc.stdout + proc.stderr


def _cas_root(root, pkg=tts):
    """A chunk-store manager root with two steps (the second changes one
    tensor), taken by the port."""
    from torchsnapshot_tpu_torch import knobs

    with knobs.override_cas_chunk_size_bytes(4096):
        mgr = tts.SnapshotManager(root, cas=True)
        for step in (1, 2):
            mgr.save(_state("port", 1 if step == 1 else 3), step=step)
    return mgr


def test_stats_doctor_and_cas_print_what_jax_prints(tmp_path, capsys):
    root = str(tmp_path / "root")
    mgr = _cas_root(root)
    s1, s2 = mgr.path_for_step(1), mgr.path_for_step(2)
    plain = str(tmp_path / "plain")
    jts.Snapshot.take(plain, _state("jax", 4))
    # stats' cache section reports this process's mapped reads, as the JAX
    # CLI's does: a fresh CLI process has none
    tts.obs.reset_metrics()
    jts.obs.reset_metrics()
    for path in (s1, s2, plain):
        for extra in ([], ["--json"], ["--top", "2"]):
            rc, out, _ = _both(["stats", path, *extra], capsys)
            assert rc == 0 and path in out
    assert json.loads(_both(["stats", s2, "--json"], capsys)[1])["cas"]["chunked_objects"] > 0
    for argv in (["doctor", s1], ["doctor", s2, "--json"], ["doctor", s1, "--diff", s2],
                 ["doctor", s1, "--diff", s2, "--json"]):
        rc, out, _ = _both(argv, capsys)
        assert rc == 0 and out
    assert "cas:" in _both(["doctor", s1], capsys)[1]
    for argv in (["cas", f"{root}/cas"], ["cas", f"{root}/cas", "--json"],
                 ["cas", f"{root}/cas", "--fsck", "--json"]):
        rc, out, _ = _both(argv, capsys)
        assert rc == 0 and "live" in out
    # gc: on two pools built alike (refs are absolute paths), step 1 deleted
    # by hand (metadata only), so the sweep has chunks to take
    outs = []
    for pkg_main, name in ((port_main, "p"), (jax_main, "j")):
        r = str(tmp_path / name)
        _cas_root(r)
        os.remove(f"{r}/step_0000000001/.snapshot_metadata")
        for argv in (["cas", f"{r}/cas", "--gc", "--grace", "0", "--json"], ["cas", f"{r}/cas", "--gc"]):
            rc, out, err = _run(pkg_main, argv, capsys)
            outs.append((rc, out.replace(r, "<root>"), err))
    assert outs[:2] == outs[2:] and json.loads(outs[0][1])["gc"]["swept_chunks"] > 0
    # ls reads the manifest only; delete leaves the pool's chunks to GC
    # (step 1's refs are released, step 2's chunks stay)
    assert _both(["ls", s1], capsys)[0] == 0
    pool = set(os.listdir(f"{root}/cas/objects"))
    rc, out, _ = _run(port_main, ["delete", s1, "--yes"], capsys)
    assert rc == 0 and out == f"deleted {s1}\n" and not os.path.exists(s1)
    assert set(os.listdir(f"{root}/cas/objects")) == pool
    index = jts.cas.ChunkIndex.load(jts.cas.ChunkStore(f"{root}/cas"))
    assert not any(s1 in e["refs"] for e in index.chunks.values())
    assert jts.verify_snapshot(s2, deep=True).ok and tts.verify_snapshot(s2, deep=True).ok
    # a corrupt index: the same message and code
    with open(f"{root}/cas/index.json", "ab") as f:
        f.write(b"x")
    for argv in (["cas", f"{root}/cas"], ["cas", f"{root}/cas", "--json"]):
        assert _both(argv, capsys)[0] == 1
    # a continuous host root and one of its stores: the JAX CLI's rollup
    from torchsnapshot_tpu_torch.continuous import ContinuousStore

    cont = tmp_path / "cont"
    store = ContinuousStore(str(cont / "r0"))
    store.write_state(3, {"app/w": torch.arange(5000, dtype=torch.float32)}, chunk_size=4096)
    store.sync_close()
    for path in (str(cont), str(cont / "r0")):
        for argv in (["stats", path], ["stats", path, "--json"]):
            rc, out, _ = _both(argv, capsys)
            assert rc == 0 and "head" in out
    # a publication root is not ported
    os.makedirs(tmp_path / "pub")
    (tmp_path / "pub" / ".snapshot_metadata").write_text('{"format": "tsnp-publication-head"}')
    rc, out, err = _run(port_main, ["stats", str(tmp_path / "pub")], capsys)
    assert rc == 1 and out == "" and "queue A item 5.4" in err


_READ_PATH = ("materialize", "pipeline/budget_admission", "pipeline/io", "pipeline/consume",
              "storage/read", "storage/mmap_read")


def test_trace_writes_perfetto_with_the_jax_read_path_spans(tmp_path, capsys):
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, _state("port", 5))
    names = {}
    for pkg_main, argv in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        out_file = str(tmp_path / f"{len(names)}.json")
        rc, out, _ = _run(pkg_main, ["trace", path, "--out", out_file, *argv], capsys)
        assert rc == 0 and out.startswith("wrote ") and out.endswith(f" spans to {out_file}\n")
        events = json.load(open(out_file))["traceEvents"]
        names[len(names)] = sorted(
            e["name"] for e in events if e.get("ph") == "X" and e["name"] in _READ_PATH
        )
    assert names[0] == names[1] and "storage/mmap_read" in names[0]


def _reference_snapshot(tmp_path, world_size):
    ref = tmp_path / f"ref{world_size}"
    ref.mkdir()
    (ref / "0").mkdir()
    (ref / "0" / "w").write_bytes(np.arange(6, dtype=np.float32).tobytes())
    manifest = {
        "0/app": {"type": "dict", "keys": ["n", "w"]},
        "0/app/n": {"type": "int", "serialized_value": "1", "replicated": False, "readable": None},
        "0/app/w": {"type": "Tensor", "location": "0/w", "serializer": "buffer_protocol",
                    "dtype": "torch.float32", "shape": [2, 3], "replicated": False},
    }
    (ref / ".snapshot_metadata").write_text(
        json.dumps({"version": "0.1.0", "world_size": world_size, "manifest": manifest}))
    return str(ref)


def test_convert_writes_what_the_jax_cli_writes_in_both_directions(tmp_path, capsys):
    native = str(tmp_path / "native")
    jts.Snapshot.take(native, _state("jax", 6))
    refs = {}
    for pkg_main, name, extra in ((port_main, "p", ["--device", "cpu"]), (jax_main, "j", [])):
        refs[name] = str(tmp_path / f"ref_{name}")
        rc, out, err = _run(pkg_main, ["convert", "--to-reference", native, refs[name], *extra], capsys)
        assert rc == 0 and out == f"exported {native} -> {refs[name]} (reference format)\n", err
    files = {}
    for name, root in refs.items():
        files[name] = {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(root) for f in fs}
    assert files["p"] == files["j"] and len(files["p"]) == 4
    # back to native, by both CLIs: each package reads each result alike
    backs = {}
    for pkg_main, name, extra in ((port_main, "p", ["--device", "cpu"]), (jax_main, "j", [])):
        backs[name] = str(tmp_path / f"back_{name}")
        rc, out, _ = _run(pkg_main, ["convert", refs[name], backs[name], *extra], capsys)
        assert rc == 0 and out == f"imported {refs[name]} -> {backs[name]} (native format)\n"
    want = _state("jax", 6)["app"]
    for back in backs.values():
        assert jts.Snapshot(back).read_object("0/app/step") == 6
        for k in ("w", "ids", "e"):
            got = tts.Snapshot(back).read_object(f"0/app/{k}", device="cpu")
            assert np.array_equal(got.numpy(), want[k]) and np.array_equal(jts.Snapshot(back).read_object(f"0/app/{k}"), want[k])
    assert _both(["ls", backs["p"]], capsys)[1] == _both(["ls", backs["j"]], capsys)[1].replace(backs["j"], backs["p"])


def test_convert_rank_gate_and_errors_print_what_jax_prints(tmp_path, capsys):
    ref = _reference_snapshot(tmp_path, 4)
    out = str(tmp_path / "out")
    rc, _, err = _both(["convert", ref, out], capsys)
    assert rc == 1 and "world_size=4" in err and "--rank N" in err
    rc, _, err = _both(["convert", "--rank", "4", ref, out], capsys)
    assert rc == 1 and "out of range" in err
    rc, _, err = _both(["convert", "--rank", "-1", ref, out], capsys)
    assert rc == 1 and "out of range" in err
    for pkg_main, extra, dest in ((port_main, ["--device", "cpu"], out), (jax_main, [], out + "j")):
        rc, _, _ = _run(pkg_main, ["convert", "--rank", "0", ref, dest, *extra], capsys)
        assert rc == 0 and tts.Snapshot(dest).read_object("0/app/n") == 1
    assert tts.Snapshot(out).read_object("0/app/w", device="cpu").shape == (2, 3)
    # a dtype the reference format cannot carry: one clean line each
    native = str(tmp_path / "f8")
    tts.Snapshot.take(native, {"m": tts.StateDict(q=torch.zeros(2, dtype=torch.float8_e4m3fn))})
    port = _run(port_main, ["convert", "--to-reference", native, str(tmp_path / "r1"), "--device", "cpu"], capsys)
    jax = _run(jax_main, ["convert", "--to-reference", native, str(tmp_path / "r2")], capsys)
    assert port == jax and port[0] == 1 and port[2].startswith("error: dtype 'float8_e4m3fn'")
