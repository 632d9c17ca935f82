"""Ring attention over more than one rank in the port
(``torchsnapshot_tpu_torch/parallel/ring_attention.py``) against the JAX
package's ``ring_attention`` on a CPU mesh of the same size, and the
rotation helpers of ``parallel/collectives.py`` on their own.

Ranks are subprocesses over a gloo process group on the CPU
(``run_workers(kind="gloo")`` from ``test_torch_distributed.py``, each
run with its own timeout); the CPU tensors take the flash partials'
plain versions, which keep the kernels' contract.  The JAX side runs its
Pallas kernels in interpret mode (``knobs.override_pallas_attention(1)``,
as ``tests/test_ring_attention.py:27-36`` does).  At ring size 2 and 4,
causal and full: each rank's output shard within 2e-5 of the JAX
output's, and the gradients of q, k and v (a seeded cotangent) within
1e-4 of ``jax.grad``'s.  Inputs come from seeded numpy generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.parallel.ring_attention import ring_attention as jax_ring
from test_torch_distributed import run_workers

B, S, H, D = 2, 32, 4, 16

_BODY = """
    import torch.distributed as dist
    from torchsnapshot_tpu_torch.parallel import collectives
    from torchsnapshot_tpu_torch.parallel.ring_attention import ring_attention

    data = np.load(INPUTS)
    s_local = data["q"].shape[1] // world
    shard = lambda a: torch.from_numpy(a[:, rank * s_local:(rank + 1) * s_local].copy())  # noqa: E731
    out = {}
    for causal in (True, False):
        q, k, v = (shard(data[n]).requires_grad_() for n in "qkv")
        o = ring_attention(q, k, v, causal=causal)
        grads = torch.autograd.grad(o, (q, k, v), shard(data["ct"]))
        tag = "causal" if causal else "full"
        out[f"out_{tag}"] = o.detach().numpy()
        for n, g in zip("qkv", grads):
            out[f"d{n}_{tag}"] = g.numpy()
    # the helpers alone: rank r holds r * 10 + [0, 1, 2]
    t = (torch.arange(3.0) + 10 * rank).requires_grad_()
    for shift in (1, -1, 2):
        moved = collectives.ppermute(t, shift=shift)
        (g,) = torch.autograd.grad(moved, t, torch.full((3,), float(rank + 1)))
        out[f"ppermute{shift}"] = moved.detach().numpy()
        out[f"ppermute{shift}_grad"] = g.numpy()
    src = world - 1
    sent = collectives.broadcast_from(t * 2, src=src)
    (g,) = torch.autograd.grad(sent.sum(), t)
    out["bcast"], out["bcast_grad"] = sent.detach().numpy(), g.numpy()
    out["timeout_s"] = np.array(collectives.group_timeout().total_seconds())
    np.savez(f"{OUT}{rank}.npz", **out)
"""


def _inputs():
    rng = np.random.default_rng(21)
    return {n: rng.standard_normal((B, S, H, D)).astype(np.float32) for n in ("q", "k", "v", "ct")}


_RESULTS = {}


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def ring(request, tmp_path_factory):
    """The workers' results at one ring size (computed once a module)."""
    world = request.param
    if world not in _RESULTS:
        tmp = tmp_path_factory.mktemp(f"ring{world}")
        data = _inputs()
        np.savez(tmp / "inputs.npz", **data)
        head = f"""
        INPUTS = {str(tmp / 'inputs.npz')!r}
        OUT = {str(tmp / 'rank')!r}"""
        run_workers(tmp, world, head + _BODY, kind="gloo")
        ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
        _RESULTS[world] = {"world": world, "data": data, "ranks": ranks}
    return _RESULTS[world]


def _jax_ring(data, world, causal):
    """The JAX ring's output and ``jax.grad`` of <output, ct> in q, k, v."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    sharding = NamedSharding(mesh, P(None, "sp", None, None))
    q, k, v = (jax.device_put(jnp.asarray(data[n]), sharding) for n in "qkv")
    ct = jnp.asarray(data["ct"])
    with jknobs.override_pallas_attention(1):
        out, vjp = jax.vjp(lambda q, k, v: jax_ring(q, k, v, mesh, axis_name="sp", causal=causal), q, k, v)
        grads = vjp(ct)  # jax.grad of <output, ct>
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_output_and_gradients_match_jax(ring, causal):
    world, data = ring["world"], ring["data"]
    tag = "causal" if causal else "full"
    want, want_grads = _jax_ring(data, world, causal)
    s_local = S // world
    for r, got in enumerate(ring["ranks"]):
        cut = slice(r * s_local, (r + 1) * s_local)
        np.testing.assert_allclose(got[f"out_{tag}"], want[:, cut], rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")
        for n, g in zip("qkv", want_grads):
            np.testing.assert_allclose(
                got[f"d{n}_{tag}"], g[:, cut], rtol=1e-4, atol=1e-4, err_msg=f"rank {r} d{n}"
            )


def test_rotation_helpers_forward_and_backward(ring):
    """``ppermute`` moves rank i's tensor to rank i + shift and the
    gradient back; ``broadcast_from`` hands every rank the source's
    tensor and the source alone its own gradient; waits are bounded by
    the group's timeout (gloo's default, 30 minutes, here)."""
    world = ring["world"]
    for r, got in enumerate(ring["ranks"]):
        for shift in (1, -1, 2):
            src, dst = (r - shift) % world, (r + shift) % world
            np.testing.assert_array_equal(got[f"ppermute{shift}"], np.arange(3.0) + 10 * src)
            # <moved, c_r> with c_r = r + 1: rank r's tensor reached rank dst
            np.testing.assert_array_equal(got[f"ppermute{shift}_grad"], np.full(3, float(dst + 1)))
        last = world - 1
        np.testing.assert_array_equal(got["bcast"], 2 * (np.arange(3.0) + 10 * last))
        np.testing.assert_array_equal(got["bcast_grad"], np.full(3, 2.0 if r == last else 0.0))
        assert float(got["timeout_s"]) == 1800.0
