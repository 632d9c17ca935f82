"""The port's GPipe pipeline (``torchsnapshot_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``torchsnapshot_tpu/parallel/pipeline.py``):
stages are ranks, subprocesses over a gloo process group on the CPU
(``run_workers(kind="gloo")`` from ``test_torch_distributed.py``, each
run with its own timeout), the JAX references on the 8-device CPU mesh of
``tests/conftest.py``.  Inputs are drawn from seeded numpy generators.

At world 2 and 4: the forward against the JAX ``pipeline_forward`` and
the port's ``sequential_forward``, the gradients against ``jax.grad`` of
the JAX pipeline (``tests/test_pipeline.py:44-62``), three
``pipeline_train_step``s against the JAX ones, the ``ValueError``s of a
mismatched depth and an indivisible batch, and the elastic restore of
``tests/test_pipeline.py:80-127``: a world-4 take restored onto a 2-rank
``"pp"`` mesh and replicated at world 1, by both packages.  Tolerance
1e-5 (f32, another summation order), bitwise for restores."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.parallel import pipeline as jpp
from torchsnapshot_tpu_torch.parallel import pipeline as tpp
from test_torch_distributed import run_workers

D, BATCH = 16, 8
N_MICRO = {2: 2, 4: 4}
TOL = dict(rtol=1e-5, atol=1e-5)

_BODY = """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torchsnapshot_tpu_torch.parallel import pipeline as pp

    data = np.load(INPUTS)
    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("pp",))
    full = {"w": torch.from_numpy(data["w"]), "b": torch.from_numpy(data["b"])}
    params = pp.shard_pipeline_params(full, mesh)
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    out = pp.pipeline_forward(params, x, mesh, n_microbatches=N_MICRO)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = torch.mean((pp.pipeline_forward(p, x, mesh, n_microbatches=N_MICRO) - y) ** 2)
    gw, gb = torch.autograd.grad(loss, [p["w"], p["b"]])
    q, losses = params, []
    for _ in range(3):
        q, step_loss = pp.pipeline_train_step(q, x, y, mesh)
        losses.append(float(step_loss))
    errors = []
    for bad in (lambda: pp.pipeline_forward(params, x[:5], mesh, n_microbatches=N_MICRO),
                lambda: pp.pipeline_forward(
                    pp.shard_pipeline_params({k: torch.cat([v, v]) for k, v in full.items()}, mesh),
                    x, mesh, n_microbatches=N_MICRO)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    np.savez(f"{OUT}{rank}.npz", out=out.numpy(), gw=gw.to_local().numpy(), gb=gb.to_local().numpy(),
             losses=np.array(losses), w3=q["w"].to_local().numpy(), b3=q["b"].to_local().numpy(),
             errors=np.array(errors))
    if world == 4:
        tts.Snapshot.take(snap_dir, {"pp": tts.StateDict(q)}, coordinator=coord)
"""

_RESTORE_BODY = """
    from torch.distributed.device_mesh import DeviceMesh
    from torchsnapshot_tpu_torch.parallel import pipeline as pp
    from torchsnapshot_tpu_torch.parallel.mesh import distribute, placements_from_spec

    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("pp",))
    dest = tts.StateDict(
        w=distribute(torch.zeros(4, 16, 16), mesh, placements_from_spec(("pp",), (2,), ("pp",))),
        b=distribute(torch.zeros(4, 16), mesh, placements_from_spec(("pp",), (2,), ("pp",))),
    )
    tts.Snapshot(snap_dir).restore({"pp": dest})
    x = torch.from_numpy(np.load(INPUTS)["x"])[:4]
    try:
        pp.pipeline_forward(dest, x, mesh, n_microbatches=2)
    except ValueError as e:
        assert "pp axis size" in str(e), e
    else:
        raise AssertionError("4 stages ran on a 2-rank mesh")
    np.savez(f"{OUT}{rank}.npz", w=dest["w"].to_local().numpy(), b=dest["b"].to_local().numpy())
"""


def _inputs(world):
    rng = np.random.default_rng(100 + world)
    return {
        "w": (rng.standard_normal((world, D, D)) / np.sqrt(D)).astype(np.float32),
        "b": (0.1 * rng.standard_normal((world, D))).astype(np.float32),
        "x": rng.standard_normal((BATCH, D)).astype(np.float32),
        "y": rng.standard_normal((BATCH, D)).astype(np.float32),
    }


def _body(body, tmp_path, world, tag):
    head = f"""
    INPUTS = {str(tmp_path / 'inputs.npz')!r}
    OUT = {str(tmp_path / tag)!r}
    N_MICRO = {N_MICRO[world]}"""
    return head + body


_RESULTS = {}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def pipe(request, tmp_path_factory):
    return _results(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def pipe4(tmp_path_factory):
    return _results(4, tmp_path_factory)


def _results(world, tmp_path_factory):
    """The workers' results at one world size, and the JAX references
    (computed once a module)."""
    if world in _RESULTS:
        return _RESULTS[world]
    tmp_path = tmp_path_factory.mktemp(f"pipe{world}")
    data = _inputs(world)
    np.savez(tmp_path / "inputs.npz", **data)
    run_workers(tmp_path, world, _body(_BODY, tmp_path, world, "rank"), kind="gloo")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    mesh = Mesh(np.array(jax.devices()[:world]), ("pp",))
    jparams = jpp.shard_pipeline_params({"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}, mesh)
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    jout = jpp.pipeline_forward(jparams, x, mesh, n_microbatches=N_MICRO[world])
    jgrads = jax.grad(
        lambda p: jnp.mean((jpp.pipeline_forward(p, x, mesh, n_microbatches=N_MICRO[world]) - y) ** 2)
    )(jparams)
    q, jlosses = jparams, []
    for _ in range(3):
        q, loss = jpp.pipeline_train_step(q, x, y, mesh)
        jlosses.append(float(loss))
    jax_ref = {"out": np.asarray(jout), "gw": np.asarray(jgrads["w"]), "gb": np.asarray(jgrads["b"]),
               "losses": np.array(jlosses), "w3": np.asarray(q["w"]), "b3": np.asarray(q["b"])}
    _RESULTS[world] = {"world": world, "data": data, "ranks": ranks, "jax": jax_ref, "tmp": tmp_path}
    return _RESULTS[world]


def test_forward_matches_jax_and_sequential(pipe):
    data = pipe["data"]
    seq = tpp.sequential_forward(
        {"w": torch.from_numpy(data["w"]), "b": torch.from_numpy(data["b"])}, torch.from_numpy(data["x"])
    ).numpy()
    np.testing.assert_allclose(seq, np.asarray(jpp.sequential_forward(data, data["x"])), **TOL)
    for r, got in enumerate(pipe["ranks"]):
        # every rank holds the last stage's outputs
        np.testing.assert_allclose(got["out"], pipe["jax"]["out"], **TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["out"], seq, **TOL, err_msg=f"rank {r}")


def test_gradients_match_jax_grad(pipe):
    """Each rank holds its stage's gradient; stacked, they are ``jax.grad``
    of the JAX pipeline (a psum-style backward of the broadcast would
    give world times too much)."""
    for k in ("gw", "gb"):
        got = np.concatenate([r[k] for r in pipe["ranks"]])
        np.testing.assert_allclose(got, pipe["jax"][k], **TOL, err_msg=k)
    # and the sequential oracle's autograd gradient
    data = pipe["data"]
    w, b = (torch.from_numpy(data[k]).requires_grad_() for k in ("w", "b"))
    loss = torch.mean((tpp.sequential_forward({"w": w, "b": b}, torch.from_numpy(data["x"]))
                       - torch.from_numpy(data["y"])) ** 2)
    gw, gb = torch.autograd.grad(loss, [w, b])
    np.testing.assert_allclose(np.concatenate([r["gw"] for r in pipe["ranks"]]), gw.numpy(), **TOL)
    np.testing.assert_allclose(np.concatenate([r["gb"] for r in pipe["ranks"]]), gb.numpy(), **TOL)


def test_three_train_steps_match_jax(pipe):
    for r, got in enumerate(pipe["ranks"]):
        np.testing.assert_allclose(got["losses"], pipe["jax"]["losses"], rtol=1e-5, err_msg=f"rank {r}")
    assert pipe["jax"]["losses"][-1] < pipe["jax"]["losses"][0]
    for k in ("w3", "b3"):
        got = np.concatenate([r[k] for r in pipe["ranks"]])
        np.testing.assert_allclose(got, pipe["jax"][k], **TOL, err_msg=k)


def test_mismatched_depth_and_batch_raise_value_errors(pipe):
    for r, got in enumerate(pipe["ranks"]):
        batch_err, depth_err = (str(e) for e in got["errors"])
        assert "not divisible by" in batch_err, (r, batch_err)
        assert f"stage dim {2 * pipe['world']} != pp axis size {pipe['world']}" in depth_err, (r, depth_err)


def test_params_and_spans_match_jax(tmp_path):
    """``init_pipeline_params`` draws the JAX package's shapes and scale;
    one stage on a 1-rank mesh (a gloo group in this process, torn down
    after) is the sequential stack, and the forward and the step record
    the JAX package's spans with its attributes."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu import knobs as jknobs
    from torchsnapshot_tpu import obs as jobs
    from torchsnapshot_tpu_torch import knobs as tknobs
    from torchsnapshot_tpu_torch import obs as tobs

    params = tpp.init_pipeline_params(4, 64, seed=torch.Generator().manual_seed(3), device="cpu")
    jparams = jpp.init_pipeline_params(jax.random.PRNGKey(0), 4, 64)
    for k in ("w", "b"):
        assert tuple(params[k].shape) == jparams[k].shape and params[k].dtype == torch.float32
    assert not params["b"].any()
    assert abs(float(params["w"].std()) - float(jnp.std(jparams["w"]))) < 0.01
    assert torch.equal(params["w"], tpp.init_pipeline_params(4, 64, seed=3, device="cpu")["w"])

    data = _inputs(1)
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    full = {k: torch.from_numpy(data[k]) for k in ("w", "b")}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    tracer = tobs.get_tracer()
    try:
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("pp",))
        with tknobs.override_trace(1):
            tracer.reset()
            out = tpp.pipeline_forward(tpp.shard_pipeline_params(full, mesh), x, mesh, n_microbatches=2)
            tpp.pipeline_train_step(tpp.shard_pipeline_params(full, mesh), x, y, mesh)
            got = sorted((sp.name, tuple(sorted(sp.attrs.items()))) for sp in tracer.spans())
    finally:
        tracer.reset()
        dist.destroy_process_group()
    np.testing.assert_allclose(out.numpy(), tpp.sequential_forward(full, x).numpy(), **TOL)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("pp",))
    jtracer = jobs.get_tracer()
    with jknobs.override_trace(1):
        jtracer.reset()
        jfull = jpp.shard_pipeline_params({k: jnp.asarray(v) for k, v in full.items()}, jmesh)
        jpp.pipeline_forward(jfull, jnp.asarray(data["x"]), jmesh, n_microbatches=2)
        jpp.pipeline_train_step(jfull, jnp.asarray(data["x"]), jnp.asarray(data["y"]), jmesh)
        want = sorted((sp.name, tuple(sorted(sp.attrs.items()))) for sp in jtracer.spans())
    jtracer.reset()
    assert got == want and [n for n, _ in got] == ["pp/forward", "pp/forward", "pp/train_step"], got


def test_elastic_restore_onto_another_depth_and_replicated(pipe4):
    """The world-4 take (after three steps) restored onto a 2-rank ``"pp"``
    mesh (two stages a rank; the 2-stage pipeline refuses it), and
    replicated at world 1 by the port and by the JAX package, bitwise;
    ``sequential_forward`` on the restored weights is the trained
    stack's."""
    pipe = pipe4
    tmp = pipe["tmp"]
    want = {k: np.concatenate([r[k + "3"] for r in pipe["ranks"]]) for k in ("w", "b")}
    run_workers(tmp, 2, _body(_RESTORE_BODY, tmp, 4, "restore"), kind="gloo", kv="kv2")
    for k in ("w", "b"):
        got = np.concatenate([dict(np.load(tmp / f"restore{r}.npz"))[k] for r in range(2)])
        assert got.tobytes() == want[k].tobytes(), k
    dest = tts.StateDict(w=torch.zeros(4, D, D), b=torch.zeros(4, D))
    tts.Snapshot(str(tmp / "snap")).restore({"pp": dest})
    jdest = jts.StateDict(w=np.zeros((4, D, D), np.float32), b=np.zeros((4, D), np.float32))
    jts.Snapshot(str(tmp / "snap")).restore({"pp": jdest})
    for k in ("w", "b"):
        assert dest[k].numpy().tobytes() == want[k].tobytes() == np.asarray(jdest[k]).tobytes(), k
    x = torch.from_numpy(pipe["data"]["x"])
    np.testing.assert_array_equal(
        tpp.sequential_forward(dest, x).numpy(),
        tpp.sequential_forward({k: torch.from_numpy(v) for k, v in want.items()}, x).numpy(),
    )
    assert os.path.exists(tmp / "snap" / ".snapshot_metadata")
