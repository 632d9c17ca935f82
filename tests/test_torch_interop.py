"""The port's interop with the original torchsnapshot format
(``tricks/``) against the JAX package's.

Reader: synthetic reference-format snapshots, built as
``tests/test_torchsnapshot_import.py`` builds them (quantized and
``torch_save`` payloads made by torch here), read by both readers at
rank 0 and 1: equal values, with bf16 and fp8 compared by bit pattern,
across %-escaped keys, lists, primitives, byte ranges, chunked tensors,
the sharded union, DTensor boxes with replicated duplicates, the rank
view's replicated overlay and zero-element tensors; the same errors for
broken manifests, an unknown dtype, a ``torch_save`` bf16 tensor and the
pickle gate; YAML metadata, with ``yaml`` imported only for it.
Writer: for the same state the two writers' files are byte-identical,
and they refuse the same leaves with the same messages; modules,
optimizers and a DTensor on a one-rank mesh export.  Adapters: DDP's
``module.`` prefix stripped and re-added as the JAX adapter does; the
optimizer adapter loading a templateless restore.  Both formats also
move through the shared ``s3://`` fake.
"""

import base64
import io
import json
import os
import struct
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.tricks import TorchModuleAdapter as JModuleAdapter
from torchsnapshot_tpu.tricks.torchsnapshot_reader import read_torchsnapshot as jax_read
from torchsnapshot_tpu.tricks.torchsnapshot_writer import write_torchsnapshot as jax_write
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.tricks import (
    TorchModuleAdapter,
    TorchOptimizerAdapter,
    peek_torchsnapshot,
    read_torchsnapshot as port_read,
    write_torchsnapshot as port_write,
)
from test_torch_s3 import fake  # noqa: F401 — the shared S3 fake fixture
from test_torchsnapshot_import import _tensor_entry, _write_snapshot


def _prim(t, sv):
    return {"type": t, "serialized_value": sv, "replicated": False, "readable": None}


def _torch_save(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _shard(loc, offsets, sizes, dtype="torch.float32"):
    return {"offsets": list(offsets), "sizes": list(sizes), "tensor": _tensor_entry(loc, dtype, sizes)}


def _synthetic(tmp_path, seed=0):
    """A reference snapshot of two ranks holding every entry kind."""
    rng = np.random.default_rng(seed)
    blobs = {}
    f32 = rng.standard_normal(11).astype(np.float32)
    blobs["0/xs"] = f32.tobytes()
    bf = rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)
    blobs["0/bf"] = bf.tobytes()
    blobs["0/f8a"] = rng.standard_normal(5).astype(ml_dtypes.float8_e4m3fn).tobytes()
    blobs["0/f8b"] = rng.standard_normal(5).astype(ml_dtypes.float8_e5m2).tobytes()
    blobs["0/empty"] = b""
    ints = rng.integers(-128, 127, (3, 2)).astype(np.int8)
    blobs["0/pt"] = ints.tobytes() + struct.pack("d", 0.25) + struct.pack("q", -3)
    pc = rng.integers(0, 255, (2, 3)).astype(np.uint8)
    blobs["0/pc"] = (struct.pack("q", 1) + pc.tobytes() + np.array([0.5, 0.125, 2.0]).tobytes()
                     + np.array([1, 0, -7], np.int64).tobytes())
    blobs["0/ts"] = _torch_save(torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float64)))
    torch.manual_seed(seed)
    blobs["0/tsq"] = _torch_save(torch.quantize_per_tensor(torch.randn(4, 2), 0.07, 3, torch.qint8))
    blobs["0/obj"] = _torch_save({"lr": 0.5, "betas": (0.9, 0.99)})
    ch = rng.standard_normal((6, 4))
    blobs["0/ch0"], blobs["0/ch1"] = ch[:4].tobytes(), ch[4:].tobytes()
    blobs["replicated/shared"] = rng.integers(0, 9, 7).astype(np.int32).tobytes()
    full = rng.standard_normal((4, 3)).astype(np.float32)
    blobs["sharded/top"], blobs["sharded/bot"] = full[:2].tobytes(), full[2:].tobytes()
    dt = rng.standard_normal((4, 6)).astype(np.float32)
    for r in range(2):  # dim 1 split over mesh dim 1, replicated over mesh dim 0
        blobs[f"sharded/dt{r}"] = np.ascontiguousarray(dt[:, 3 * r : 3 * r + 3]).tobytes()
    keys0 = ["a/b", "f", "raw", "flag", "name", "xs", "bf", "f8a", "f8b", "empty", "pt", "pc", "ts", "tsq",
             "obj", "chunked", "shared", "sh", "dt", 7]
    manifest = {
        "0/app": {"type": "dict", "keys": keys0},
        "0/app/a%2Fb": _prim("int", "42"),
        "0/app/f": _prim("float", base64.b64encode(struct.pack("d", 1.5)).decode()),
        "0/app/raw": _prim("bytes", base64.b64encode(b"xyz").decode()),
        "0/app/flag": _prim("bool", "True"),
        "0/app/name": _prim("str", "run"),
        "0/app/xs": {"type": "list"},
        **{f"0/app/xs/{i}": _tensor_entry("0/xs", "torch.float32", (1,), (4 * i, 4 * i + 4)) for i in range(11)},
        "0/app/bf": _tensor_entry("0/bf", "torch.bfloat16", (4, 3)),
        "0/app/f8a": _tensor_entry("0/f8a", "torch.float8_e4m3fn", (5,)),
        "0/app/f8b": _tensor_entry("0/f8b", "torch.float8_e5m2", (5,)),
        "0/app/empty": _tensor_entry("0/empty", "torch.bfloat16", (0, 3)),
        "0/app/pt": {**_tensor_entry("0/pt", "torch.qint8", (3, 2)), "serializer": "per_tensor_qtensor"},
        "0/app/pc": {**_tensor_entry("0/pc", "torch.quint8", (2, 3)), "serializer": "per_channel_qtensor"},
        "0/app/ts": {**_tensor_entry("0/ts", "torch.float64", (2, 5)), "serializer": "torch_save"},
        "0/app/tsq": {**_tensor_entry("0/tsq", "torch.qint8", (4, 2)), "serializer": "torch_save"},
        "0/app/obj": {"type": "object", "location": "0/obj", "serializer": "torch_save", "obj_type": "dict",
                      "replicated": False},
        "0/app/chunked": {"type": "ChunkedTensor", "dtype": "torch.float64", "shape": [6, 4], "replicated": False,
                          "chunks": [_shard("0/ch0", (0, 0), (4, 4), "torch.float64"),
                                     _shard("0/ch1", (4, 0), (2, 4), "torch.float64")]},
        "0/app/shared": {**_tensor_entry("replicated/shared", "torch.int32", (7,)), "replicated": True},
        "0/app/sh": {"type": "ShardedTensor", "shards": [_shard("sharded/top", (0, 0), (2, 3))]},
        "0/app/dt": {"type": "DTensor", "mesh": [[0, 1], [2, 3]], "dim_map": [[-1], [1]],
                     "shards": [_shard("sharded/dt0", (0, 0), (4, 3)), _shard("sharded/dt1", (0, 3), (4, 3))]},
        "0/app/7": _prim("str", "int key"),
        "1/app": {"type": "dict", "keys": ["mine", "sh", "dt"]},
        "1/app/mine": _prim("int", "1"),
        "1/app/sh": {"type": "ShardedTensor", "shards": [_shard("sharded/bot", (2, 0), (2, 3))]},
        "1/app/dt": {"type": "DTensor", "mesh": [[0, 1], [2, 3]], "dim_map": [[-1], [1]],
                     "shards": [_shard("sharded/dt1", (0, 3), (4, 3)), _shard("sharded/dt0", (0, 0), (4, 3))]},
    }
    return _write_snapshot(tmp_path, manifest, blobs)


def _bits(x):
    """A comparable numpy view: raw integers for bf16 and fp8."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            w = {1: torch.uint8, 2: torch.int16}[x.element_size()]
            return str(x.dtype).removeprefix("torch."), x.view(w).numpy().view(f"u{x.element_size()}")
        return str(x.dtype).removeprefix("torch."), x.numpy()
    x = np.asarray(x)
    if x.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        return x.dtype.name, x.view(f"u{x.dtype.itemsize}")
    return x.dtype.name, x


def _same(port, jax, where=""):
    if isinstance(jax, dict):
        assert isinstance(port, dict) and list(port) == list(jax), where
        for k in jax:
            _same(port[k], jax[k], f"{where}/{k}")
    elif isinstance(jax, list):
        assert isinstance(port, list) and len(port) == len(jax), where
        for i, (a, b) in enumerate(zip(port, jax)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(jax, np.ndarray) or isinstance(port, torch.Tensor):
        (pd, pv), (jd, jv) = _bits(port), _bits(jax)
        assert pd == jd and pv.shape == jv.shape and np.array_equal(pv, jv), (where, pd, jd)
    else:
        assert type(port) is type(jax) and port == jax, (where, port, jax)


@pytest.mark.parametrize("rank", [0, 1])
def test_reader_equals_the_jax_reader_on_every_entry_kind(tmp_path, rank, caplog):
    path = _synthetic(tmp_path)
    got = port_read(path, rank=rank, device="cpu")
    want = jax_read(path, rank=rank)
    _same(got, want)
    app = got["app"]
    assert app["sh"].shape == (4, 3) and app["dt"].shape == (4, 6)
    if rank == 0:
        assert app["a/b"] == 42 and app[7] == "int key" and len(app["xs"]) == 11
        assert app["empty"].shape == (0, 3) and app["empty"].dtype == torch.bfloat16
        assert app["pt"].dtype == app["tsq"].dtype == torch.float32  # dequantized
        port_warnings = [r for r in caplog.records if r.name.startswith("torchsnapshot_tpu_torch.")]
        assert sum("dequantized" in r.message for r in port_warnings) == 1  # once per import
    else:
        assert app["mine"] == 1 and "only0" not in app and set(app) == {"mine", "sh", "dt", "shared"}
    assert peek_torchsnapshot(path)["world_size"] == 2


def test_reader_raises_the_jax_readers_errors(tmp_path):
    def entry_snapshot(name, entry, blobs):
        return _write_snapshot(tmp_path / name, {"0/app": {"type": "dict", "keys": ["x"]}, "0/app/x": entry}, blobs)

    top = _shard("sharded/top", (0, 0), (2, 3))
    zeros = {"sharded/top": bytes(24)}
    cases = {
        "union": ({"type": "ShardedTensor", "dtype": "torch.float32", "shape": [4, 3], "shards": [top]}, zeros),
        "lost": ({"type": "DTensor", "shards": [top], "mesh": [[0], [1]], "dim_map": [[0], [-1]]}, zeros),
        "noshards": ({"type": "ShardedTensor", "shards": []}, {}),
        "dtype": (_tensor_entry("0/q", "torch.qint8", (2,)), {"0/q": b"\x00\x00"}),
        "qlen": ({**_tensor_entry("0/q", "torch.qint8", (2,)), "serializer": "per_tensor_qtensor"}, {"0/q": bytes(9)}),
        "bf16_pickle": ({**_tensor_entry("0/t", "torch.bfloat16", (2,)), "serializer": "torch_save"},
                        {"0/t": _torch_save(torch.ones(2, dtype=torch.bfloat16))}),
    }
    for name, (entry, blobs) in cases.items():
        path = entry_snapshot(name, entry, blobs)
        errs = []
        for read in (lambda: port_read(path, device="cpu"), lambda: jax_read(path)):
            with pytest.raises(ValueError) as ei:
                read()
            errs.append(str(ei.value))
        assert errs[0] == errs[1], (name, errs)
    # a payload shorter than its shape: a ValueError in both (numpy's text in JAX's)
    path = entry_snapshot("short", _tensor_entry("0/s", "torch.bfloat16", (3,)), {"0/s": bytes(4)})
    for read in (lambda: port_read(path, device="cpu"), lambda: jax_read(path)):
        with pytest.raises(ValueError, match="reshape"):
            read()
    # the pickle gate: refused by both, naming each package's knob
    path = entry_snapshot("gate", {**_tensor_entry("0/t", "torch.float32", (2,)), "serializer": "torch_save"},
                          {"0/t": _torch_save(torch.ones(2))})
    with tknobs.override_allow_pickle_objects(False), jknobs.override_allow_pickle_objects(False):
        with pytest.raises(RuntimeError, match="TORCHSNAPSHOT_TPU_TORCH_ALLOW_PICKLE_OBJECTS=1"):
            port_read(path, device="cpu")
        with pytest.raises(RuntimeError, match="ALLOW_PICKLE_OBJECTS=1"):
            jax_read(path)
    assert torch.equal(port_read(path, device="cpu")["app"]["x"], torch.ones(2))


def test_yaml_metadata_and_a_missing_yaml_module(tmp_path, monkeypatch):
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "0").mkdir()
    (snap / "0" / "w").write_bytes(np.arange(3, dtype=np.int16).tobytes())
    (snap / ".snapshot_metadata").write_text(
        "version: 0.1.0\nworld_size: 1\nmanifest:\n"
        "  0/app: {type: dict, keys: [n, w]}\n"
        "  0/app/n: {type: int, serialized_value: '3', replicated: false, readable: null}\n"
        "  0/app/w: {type: Tensor, location: 0/w, serializer: buffer_protocol, dtype: torch.int16,"
        " shape: [3], replicated: false}\n"
    )
    _same(port_read(str(snap), device="cpu"), jax_read(str(snap)))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="'yaml'"):
        port_read(str(snap), device="cpu")


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            full = os.path.join(dirpath, f)
            out[os.path.relpath(full, root)] = open(full, "rb").read()
    return out


def _export_state(seed, torch_leaves):
    rng = np.random.default_rng(seed)
    arrays = {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "b16": rng.standard_normal(8).astype(ml_dtypes.bfloat16),
        "h": rng.standard_normal(5).astype(np.float16),
        "d": rng.standard_normal(2).astype(np.float64),
        "mask": rng.integers(0, 2, 6).astype(bool),
        "i8": rng.integers(-100, 100, 4).astype(np.int8),
        "u8": rng.integers(0, 255, 4).astype(np.uint8),
        "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
        "c64": (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64),
        "scalar": np.asarray(rng.standard_normal(), np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }

    def leaf(a):
        if not torch_leaves:
            return a
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return {
        "model": {k: leaf(v) for k, v in arrays.items()},
        "progress": {"steps": 17, "name": "run", "lr": 0.5, "done": False, "history": [1, 2, (3, 4)],
                     "blob": b"\x01\x02", 0: "int key", "a/b%c": 9},
        "list_top": [leaf(arrays["w"]), 5],
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_writers_lay_down_byte_identical_files(tmp_path, seed):
    port_write(str(tmp_path / "p"), _export_state(seed, torch_leaves=True))
    jax_write(str(tmp_path / "j"), _export_state(seed, torch_leaves=False))
    p, j = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert sorted(p) == sorted(j) and len(p) > 10
    for name in j:
        assert p[name] == j[name], name
    _same(port_read(str(tmp_path / "p"), device="cpu"), jax_read(str(tmp_path / "j")))


def test_writers_refuse_the_same_leaves(tmp_path):
    cases = [
        ({"opt": {"momentum": None}}, {"opt": {"momentum": None}}),
        ({"app": {"cfg": object}}, {"app": {"cfg": object}}),
        ({"m": {"q": torch.zeros(2, dtype=torch.float8_e4m3fn)}}, {"m": {"q": np.zeros(2, ml_dtypes.float8_e4m3fn)}}),
        ({"m": {1: torch.ones(4), "1": torch.zeros(4)}}, {"m": {1: np.ones(4), "1": np.zeros(4)}}),
    ]
    for i, (port_state, jax_state) in enumerate(cases):
        errs = []
        for write, state in ((port_write, port_state), (jax_write, jax_state)):
            with pytest.raises(ValueError) as ei:
                write(str(tmp_path / f"{i}{len(errs)}"), state)
            errs.append(str(ei.value))
        assert errs[0] == errs[1], errs
        assert not os.path.exists(tmp_path / f"{i}0" / ".snapshot_metadata")


def test_modules_optimizers_and_a_one_rank_dtensor_export(tmp_path, monkeypatch):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
        dt = distribute_tensor(full, mesh, [Shard(1)])
        port_write(str(tmp_path / "s"), {"model": model, "optim": {"state": opt.state_dict()["state"]},
                                         "dt": {"x": dt}})
        monkeypatch.setattr(mesh, "size", lambda *a: 2)
        with pytest.raises(ValueError, match="shards on other ranks"):
            port_write(str(tmp_path / "s2"), {"dt": {"x": dt}})
    finally:
        if started:
            dist.destroy_process_group()
    got = jax_read(str(tmp_path / "s"))
    for k, v in model.state_dict().items():
        assert np.array_equal(got["model"][k], v.numpy()), k
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            assert np.array_equal(got["optim"]["state"][i][k], v.numpy()), (i, k)
    assert np.array_equal(got["dt"]["x"], full.numpy())
    assert not os.path.exists(tmp_path / "s2" / ".snapshot_metadata")


def test_ddp_prefix_and_optimizer_adapters(tmp_path):
    class Wrapper(torch.nn.Module):  # a DDP-shaped wrapper: keys under "module."
        def __init__(self, m):
            super().__init__()
            self.module = m

    torch.manual_seed(1)
    wrapped = Wrapper(torch.nn.Linear(3, 2))
    plain = torch.nn.Linear(3, 2)
    for adapter_cls in (TorchModuleAdapter, JModuleAdapter):
        assert sorted(adapter_cls(wrapped).state_dict()) == ["bias", "weight"]
    assert sorted(TorchModuleAdapter(plain).state_dict()) == sorted(JModuleAdapter(plain).state_dict())
    tts.Snapshot.take(str(tmp_path / "m"), {"m": TorchModuleAdapter(wrapped)})
    tts.Snapshot(str(tmp_path / "m")).restore({"m": TorchModuleAdapter(plain)})
    assert torch.equal(plain.weight, wrapped.module.weight)
    other = Wrapper(torch.nn.Linear(3, 2))
    tts.Snapshot(str(tmp_path / "m")).restore({"m": TorchModuleAdapter(other)})  # prefix added back
    assert torch.equal(other.module.bias, wrapped.module.bias)
    # an optimizer restored with no state: the materialized tensors load
    # through the adapter, and the next step equals the original's
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    x = torch.randn(4, 3)
    model(x).sum().backward()
    opt.step()
    tts.Snapshot.take(str(tmp_path / "o"), {"o": TorchOptimizerAdapter(opt), "m": model})
    model2 = torch.nn.Linear(3, 2)
    model2.load_state_dict(model.state_dict())
    opt2 = torch.optim.AdamW(model2.parameters(), lr=0.1)
    TorchOptimizerAdapter(opt2).load_state_dict(tts.Snapshot(str(tmp_path / "o")).materialize(device="cpu")["o"])
    for m, o in ((model, opt), (model2, opt2)):
        o.zero_grad()
        m(x).sum().backward()
        o.step()
    assert torch.equal(model.weight, model2.weight)
    st = opt2.state_dict()["state"][0]
    assert st["step"].device.type == "cpu" and st["exp_avg"].device == model2.weight.device


def test_both_formats_move_through_the_s3_fake(fake):  # noqa: F811
    port_write("s3://bkt/ref/p", _export_state(2, torch_leaves=True))
    jax_write("s3://bkt/ref/j", _export_state(2, torch_leaves=False))
    p = {k[len("ref/p/"):]: v for (b, k), v in fake.objects.items() if k.startswith("ref/p/")}
    j = {k[len("ref/j/"):]: v for (b, k), v in fake.objects.items() if k.startswith("ref/j/")}
    assert p == j
    _same(port_read("s3://bkt/ref/j", device="cpu"), jax_read("s3://bkt/ref/p"))
    # the metadata of a reference snapshot on S3, without a payload read
    n0 = len(fake.calls)
    assert peek_torchsnapshot("s3://bkt/ref/p")["world_size"] == 1
    assert [c[2] for c in fake.calls[n0:] if c[0] == "get"] == ["ref/p/.snapshot_metadata"]
    assert json.loads(fake.objects[("bkt", "ref/p/.snapshot_metadata")])["version"] == "0.1.0"
