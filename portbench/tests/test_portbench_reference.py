"""The plain reader against snapshots the port writes on the CPU, the
plain writer, and the comparisons."""

import math
import os
import shutil
import tempfile

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.storage import memory

from portbench.reference import fill, writer
from portbench.reference.check import (LeafSpec, check_snapshot, check_tensors, compare, count_bad_digests,
                                       passed)
from portbench.reference.reader import METADATA, PlainSnapshot


@pytest.fixture
def namespace():
    name = "portbench-test-reader"
    yield name
    memory.reset_namespace(name)


def _state():
    torch.manual_seed(0)
    return {
        "small": torch.randn(7, 3, dtype=torch.bfloat16),
        "big": torch.randn(300, 64, dtype=torch.float32),
        "ints": torch.arange(11, dtype=torch.int64),
    }


@pytest.mark.parametrize("chunk", [None, 8192])
def test_plain_reader_reads_what_the_port_wrote(namespace, chunk, monkeypatch):
    state = _state()
    if chunk:
        # big arrays split into dim-0 chunks (ChunkedArray entries)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_MAX_CHUNK_SIZE_BYTES", str(chunk))
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_SLAB_SIZE_THRESHOLD_BYTES", "1024")
    tts.Snapshot.take(f"memory://{namespace}", {"s": tts.StateDict(**state, step=5)})
    snap = PlainSnapshot(memory._NAMESPACES[namespace])
    for k, v in state.items():
        assert torch.equal(snap.tensor(f"0/s/{k}"), v)
    assert snap.primitive("0/s/step") == 5
    # every digest the take stored holds
    assert snap.digests and count_bad_digests(snap) == 0
    if chunk:
        assert snap.manifest["0/s/big"]["type"] == "ChunkedArray"


def test_plain_reader_reads_row_sharded_dtensors(namespace):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor

    d = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 's')}", rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("ep",))
        full = torch.randn(37, 8)
        table = distribute_tensor(full, mesh, [Shard(0)])
        tts.Snapshot.take(f"memory://{namespace}", {"m": tts.StateDict(table=table)})
        snap = PlainSnapshot(memory._NAMESPACES[namespace])
        assert snap.manifest["0/m/table"]["type"] == "ShardedArray"
        assert torch.equal(snap.tensor("0/m/table"), full)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def test_metadata_crc_is_checked(namespace):
    tts.Snapshot.take(f"memory://{namespace}", {"s": tts.StateDict(**_state())})
    objects = dict(memory._NAMESPACES[namespace])
    raw = bytearray(objects[METADATA])
    raw[10] ^= 1
    objects[METADATA] = bytes(raw)
    with pytest.raises(ValueError):
        PlainSnapshot(objects)


def test_writer_round_trip():
    arrays = _state()
    objects = writer.write({f"0/x/{k}": v for k, v in arrays.items()}, {"0/x/step": 3})
    snap = PlainSnapshot(objects)
    for k, v in arrays.items():
        assert torch.equal(snap.tensor(f"0/x/{k}"), v)
    assert snap.primitive("0/x/step") == 3


def test_fill_is_a_function_of_seed_version_and_index():
    a = fill.expected((1000,), torch.bfloat16, "cpu", 2**40 + 1, 3, 7, "normal")
    assert torch.equal(a, fill.expected((1000,), torch.bfloat16, "cpu", 2**40 + 1, 3, 7, "normal"))
    for other in [(2**40 + 2, 3, 7), (2**40 + 1, 4, 7), (2**40 + 1, 3, 8)]:
        assert not torch.equal(a, fill.expected((1000,), torch.bfloat16, "cpu", *other, "normal"))
    assert (fill.expected((1000,), torch.float32, "cpu", 1, 0, 0, "nonneg") >= 0).all()


def test_compare_counts_bits_not_values():
    x = torch.tensor([1.0, -0.0, float("nan")])
    assert compare(x, x.clone()) == (0, 0.0)
    assert compare(x, torch.tensor([1.0, 0.0, float("nan")]))[0] == 1  # -0.0 is not 0.0
    m, e = compare(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.5]))
    assert (m, e) == (1, 0.5)
    assert compare(torch.ones(2), torch.ones(3))[1] == math.inf


def test_checks_pass_on_exact_and_fail_on_lower_precision():
    specs = [LeafSpec("0/a/w", (64, 8), torch.bfloat16, 0, "normal"),
             LeafSpec("0/a/v", (33,), torch.float32, 1, "nonneg")]
    exact = {s.path: s.expected("cpu", 9, 2) for s in specs}
    ok = check_snapshot(writer.write(exact, {"0/a/step": 2}), specs, {"0/a/step": 2}, 9, 2, "cpu")
    assert passed(ok)
    stale = check_snapshot(writer.write(exact, {"0/a/step": 2}), specs, {"0/a/step": 2}, 9, 3, "cpu")
    assert not passed(stale) and stale["mismatched_elements"]["value"] > 0
    assert ok["bad_digests"]["value"] == 0
    missing = check_snapshot({k: v for k, v in writer.write(exact).items() if not k.endswith(".1")},
                             specs, {}, 9, 2, "cpu")
    assert missing["missing_leaves"]["value"] == 1 and missing["bad_digests"]["value"] == 2
    pairs = [(t.to(torch.float32), s) for s, t in zip(specs, exact.values())]
    assert passed(check_tensors(pairs, 9, 2, "cpu"))
