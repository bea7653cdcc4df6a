"""The port's collectives with a backward (``parallel/mesh.py``) against
``jax.lax``'s under ``shard_map``.

Each world size n in (2, 4) spawns n gloo ranks on the CPU once for this
module (``run_ranks``; the rank bodies are ``torch_parallel_ranks.py``).
On the same seeded inputs: ``ppermute`` both ways, ``all_to_all_axes``
tiled and untiled, the Megatron pair (``copy_to_group`` into a
rank-varying product, ``reduce_from_group`` out of it, on a replicated
input) and ``pmean``, each value and the gradient of ``sum(y * c)``,
where JAX takes the gradient outside ``shard_map``; ``c`` is per rank
where the output varies and replicated where it is replicated. Values
and gradients to 1e-6 (the same float32 operations; gloo and XLA sum in
their own orders). ``make_groups``' ranks against the JAX mesh's axis
indices for every ``(data, model)`` shape of the world.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from minips_tpu.parallel.mesh import make_mesh
from minips_tpu.utils.jaxcompat import shard_map
from minips_tpu_torch.parallel.mesh import run_ranks

WORLD_SIZES = (2, 4)
TOL = 1e-6
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1)]}


def _cases(n):
    rng = np.random.default_rng(n)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    x3 = arr(n, 3, 5)
    rep = np.broadcast_to(arr(1, 4, 3), (n, 4, 3)).copy()
    cases = {
        "ppermute+1": dict(op="ppermute", shift=1, x=x3, c=arr(n, 3, 5)),
        "ppermute-1": dict(op="ppermute", shift=-1, x=x3, c=arr(n, 3, 5)),
        "a2a_tiled": dict(op="all_to_all", split_axis=1, concat_axis=0,
                          tiled=True, x=arr(n, 2, 3 * n),
                          c=arr(n, 2 * n, 3)),
        "a2a_tiled_same_axis": dict(op="all_to_all", split_axis=1,
                                    concat_axis=1, tiled=True,
                                    x=arr(n, 2, 2 * n), c=arr(n, 2, 2 * n)),
        # untiled as the MoE exchange uses it (JAX's transpose of an
        # untiled exchange between two different axes fails on shapes)
        "a2a_untiled": dict(op="all_to_all", split_axis=0, concat_axis=0,
                            tiled=False, x=arr(n, n, 3, 2),
                            c=arr(n, n, 3, 2)),
        "a2a_untiled_axis1": dict(op="all_to_all", split_axis=1,
                                  concat_axis=1, tiled=False,
                                  x=arr(n, 3, n, 2), c=arr(n, 3, n, 2)),
        "megatron": dict(op="megatron", x=rep, w=arr(n, 4, 3),
                         c=np.broadcast_to(arr(1, 4, 3), (n, 4, 3)).copy()),
        "pmean": dict(op="pmean", x=arr(n, 4, 3),
                      c=np.broadcast_to(arr(1, 4, 3), (n, 4, 3)).copy()),
    }
    out = [(name, "collective", spec) for name, spec in cases.items()]
    out += [(f"axes{m}", "axes", dict(mesh=m)) for m in MESHES[n]]
    return cases, out


@pytest.fixture(scope="module")
def runs():
    out = {}
    for n in WORLD_SIZES:
        cases, spec = _cases(n)
        out[n] = cases, run_ranks(ranks.run_cases, n, spec, device="cpu")
    return out


def _jax(spec, n):
    """(y, dx) of the JAX collective on make_mesh(n): y and dx stacked by
    device where they vary, the replicated value where they do not."""
    mesh = make_mesh(n)
    op = spec["op"]
    x, c = jnp.asarray(spec["x"]), jnp.asarray(spec["c"])
    if op == "ppermute":
        s = spec["shift"]
        perm = [(i, (i + s) % n) for i in range(n)]
        body = lambda x_: jax.lax.ppermute(x_, "data", perm)  # noqa: E731
    elif op == "all_to_all":
        body = lambda x_: jax.lax.all_to_all(  # noqa: E731
            x_[0], "data", spec["split_axis"], spec["concat_axis"],
            tiled=spec["tiled"])[None]
    if op in ("ppermute", "all_to_all"):
        f = shard_map(body, mesh=mesh, in_specs=P("data"),
                      out_specs=P("data"))
        y, vjp = jax.vjp(f, x)
        return np.asarray(y), np.asarray(vjp(c)[0])
    if op == "megatron":
        f = shard_map(lambda x_, w_: jax.lax.psum(jnp.tanh(x_ * w_[0]),
                                                  "data"),
                      mesh=mesh, in_specs=(P(), P("data")), out_specs=P())
        w = jnp.asarray(spec["w"])
        y, vjp = jax.vjp(lambda x_: f(x_, w), x[0])
        return np.asarray(y), np.asarray(vjp(c[0])[0])
    f = shard_map(lambda x_: jax.lax.pmean(jnp.sin(x_[0]), "data"),
                  mesh=mesh, in_specs=P("data"), out_specs=P())
    y, vjp = jax.vjp(f, x)
    return np.asarray(y), np.asarray(vjp(c[0])[0])


COLLECTIVES = ["ppermute+1", "ppermute-1", "a2a_tiled",
               "a2a_tiled_same_axis", "a2a_untiled", "a2a_untiled_axis1",
               "megatron", "pmean"]


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_and_its_gradient_match_jax(runs, n, name):
    cases, got = runs[n]
    spec = cases[name]
    y, dx = _jax(spec, n)
    replicated_out = spec["op"] in ("megatron", "pmean")
    for r in range(n):
        mine = got[r][name]
        np.testing.assert_allclose(mine["y"], y if replicated_out else y[r],
                                   rtol=0, atol=TOL)
        want_dx = dx if spec["op"] == "megatron" else dx[r]
        np.testing.assert_allclose(mine["dx"], want_dx, rtol=0, atol=TOL)


@pytest.mark.parametrize("n,shape", [(n, m) for n in WORLD_SIZES
                                     for m in MESHES[n]])
def test_make_groups_matches_the_jax_mesh(runs, n, shape):
    """Rank ``d·model_size + m`` sits at (d, m) of ``make_mesh(n_data,
    model_size=)``: the axis indices of every rank equal JAX's."""
    n_data, model = shape
    mesh = make_mesh(n_data, model_size=model)
    f = shard_map(lambda: jnp.stack([jax.lax.axis_index("data"),
                                     jax.lax.axis_index("model")])[None],
                  mesh=mesh, in_specs=(), out_specs=P(("data", "model")))
    want = np.asarray(f())  # by device, in mesh order: rank d*model + m
    for r in range(n):
        got = runs[n][1][r][f"axes{shape}"]
        assert (got["data"], got["model"]) == tuple(want[r])
        assert (got["data_size"], got["model_size"]) == shape
