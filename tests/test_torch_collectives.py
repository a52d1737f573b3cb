"""The port's ring collective matmuls and int8 cross-pod all-reduce,
across 4 gloo ranks, against ``repro``'s on one CPU device under
``jax.vmap(..., axis_name=)`` (which carries their named-axis
collectives): ``all_gather_matmul`` and ``matmul_reduce_scatter`` (M, K,
N = 64, 128, 256, f32, within 1e-5) on the world's ring, on a (2, 2)
mesh's "model" ring and at a group of one; ``compressed_all_reduce``
with and without error feedback over 10 steps (int32 totals equal,
outputs within 1e-6); and ``compress_int8``, ``decompress_int8`` and
``apply_error_feedback`` on their own.  One world of ranks runs every
case."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.parallel import crosspod as jcross  # noqa: E402
from repro.parallel import overlap as joverlap  # noqa: E402

from repro_torch.parallel import crosspod  # noqa: E402

from _torch_ranks import run_ranks  # noqa: E402

M, K, N = 64, 128, 256
WORLD = 4
STEPS = 10
# (name, mesh shape, axes, the ring's axis)
RINGS = [("world", (4,), ("model",), "model"),
         ("2x2 model", (2, 2), ("data", "model"), "model"),
         ("group of one", (4, 1), ("data", "model"), "model")]

RANK_SCRIPT = r"""
import numpy as np
from repro_torch.launch.mesh import make_mesh_from_descriptor
from repro_torch.core.hw import MeshDescriptor
from repro_torch.parallel import (all_gather_matmul, compressed_all_reduce,
                                  matmul_reduce_scatter)
inp = np.load(os.path.join(WORK, "inputs.npz"))
x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
out = {}
for i, (shape, axes, ring) in enumerate(RINGS):
    mesh = make_mesh_from_descriptor(MeshDescriptor(shape, axes), "cpu")
    group = mesh.get_group(ring)
    g, r = dist.get_world_size(group), dist.get_rank(group)
    n, k = N // g, K // g
    out[f"agm{i}"] = all_gather_matmul(x, w[:, r * n:(r + 1) * n], group)
    out[f"mrs{i}"] = matmul_reduce_scatter(x[:, r * k:(r + 1) * k],
                                           w[r * k:(r + 1) * k], group)
err = torch.zeros(inp["grads"].shape[2:])
for t in range(inp["grads"].shape[0]):
    g_t = torch.from_numpy(inp["grads"][t, RANK])
    out[f"plain{t}"] = compressed_all_reduce(g_t)
    out[f"ef{t}"], err = compressed_all_reduce(g_t, error=err)
np.savez(os.path.join(WORK, f"out{RANK}.npz"),
         **{k: v.numpy() for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, and every rank's outputs of every case."""
    work = str(tmp_path_factory.mktemp("collectives"))
    rng = np.random.default_rng(0)
    inputs = {"x": rng.standard_normal((M, K)).astype(np.float32),
              "w": (0.1 * rng.standard_normal((K, N))).astype(np.float32),
              # rank-varying gradients, rows of mixed magnitude
              "grads": (rng.standard_normal((STEPS, WORLD, 8, 96))
                        * np.geomspace(1e-3, 10, 96)).astype(np.float32)}
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    script = (f"RINGS = {[r[1:] for r in RINGS]!r}\nN, K = {N}, {K}\n"
              + RANK_SCRIPT)
    run_ranks(script, work, WORLD)
    outs = [dict(np.load(os.path.join(work, f"out{r}.npz")))
            for r in range(WORLD)]
    return inputs, outs


def _ring_ranks(shape, axes, ring):
    """For each global rank: (its ring's size, its index in the ring)."""
    coords = np.indices(shape).reshape(len(shape), -1).T
    d = axes.index(ring)
    return [(shape[d], int(c[d])) for c in coords]


@pytest.mark.parametrize("case", range(len(RINGS)),
                         ids=[r[0] for r in RINGS])
def test_all_gather_matmul_matches_repro(world, case):
    inputs, outs = world
    _, shape, axes, ring = RINGS[case]
    for rank, (g, r) in enumerate(_ring_ranks(shape, axes, ring)):
        x, w = jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"])
        shards = jnp.stack(jnp.split(w, g, axis=1))
        want = jax.vmap(lambda ws: joverlap.all_gather_matmul(x, ws, "m"),
                        axis_name="m")(shards)[r]
        got = outs[rank][f"agm{case}"]
        assert got.shape == (M, N)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, inputs["x"] @ inputs["w"], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("case", range(len(RINGS)),
                         ids=[r[0] for r in RINGS])
def test_matmul_reduce_scatter_matches_repro(world, case):
    inputs, outs = world
    _, shape, axes, ring = RINGS[case]
    for rank, (g, r) in enumerate(_ring_ranks(shape, axes, ring)):
        xs = jnp.stack(jnp.split(jnp.asarray(inputs["x"]), g, axis=1))
        ws = jnp.stack(jnp.split(jnp.asarray(inputs["w"]), g, axis=0))
        want = jax.vmap(lambda a, b: joverlap.matmul_reduce_scatter(
            a, b, "m"), axis_name="m")(xs, ws)[r]
        got = outs[rank][f"mrs{case}"]
        assert got.shape == (M, N // g)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("feedback", [False, True], ids=["plain", "ef"])
def test_compressed_all_reduce_matches_repro(world, feedback):
    """10 steps, every rank: the int32 totals (the output over the
    common scale, the largest of the ranks' row scales) equal, the
    outputs within 1e-6."""
    inputs, outs = world
    grads = jnp.asarray(inputs["grads"])
    err = jnp.zeros(grads.shape[1:])
    key = "ef" if feedback else "plain"
    for t in range(STEPS):
        quantized = grads[t] + err if feedback else grads[t]
        smax = np.asarray(jnp.max(jax.vmap(
            lambda x: jcross.compress_int8(x)[1])(quantized), axis=0))
        if feedback:
            want, err = jax.vmap(lambda x, e: jcross.compressed_psum(
                x, "pod", e), axis_name="pod")(grads[t], err)
        else:
            want = jax.vmap(lambda x: jcross.compressed_psum(x, "pod"),
                            axis_name="pod")(grads[t])
        want = np.asarray(want)
        for rank in range(WORLD):
            got = outs[rank][f"{key}{t}"]
            np.testing.assert_array_equal(np.round(got / smax),
                                          np.round(want[rank] / smax))
            np.testing.assert_allclose(got, want[rank], rtol=0, atol=1e-6)


SHAPES = [(96,), (8, 96), (3, 4, 33)]


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.geomspace(1e-4, 10, shape[-1])
    if len(shape) > 1:
        x[0] = 0.0                       # a zero row takes the scale 1
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_compress_int8_matches_repro(shape):
    x = _rows(shape, 1)
    q, scale = crosspod.compress_int8(torch.from_numpy(x))
    jq, jscale = jcross.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    q0, s0 = crosspod.compress_int8(torch.tensor(2.5))
    jq0, js0 = jcross.compress_int8(jnp.asarray(2.5))
    assert q0.tolist() == np.asarray(jq0).tolist()
    assert s0.tolist() == np.asarray(js0).tolist()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decompress_int8_matches_repro(shape):
    x = _rows(shape, 2)
    jq, jscale = jcross.compress_int8(jnp.asarray(x))
    q, scale = torch.from_numpy(np.array(jq)), torch.from_numpy(
        np.array(jscale))
    np.testing.assert_array_equal(
        crosspod.decompress_int8(q, scale).numpy(),
        np.asarray(jcross.decompress_int8(jq, jscale)))
    flat = (int(np.prod(shape)),)
    np.testing.assert_array_equal(
        crosspod.decompress_int8(q, scale, flat).numpy(),
        np.asarray(jcross.decompress_int8(jq, jscale, flat)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_apply_error_feedback_matches_repro(shape):
    x, e = _rows(shape, 3), 0.01 * _rows(shape, 4)
    got = crosspod.apply_error_feedback(torch.from_numpy(x),
                                        torch.from_numpy(e))
    want = jcross.apply_error_feedback(jnp.asarray(x), jnp.asarray(e))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
