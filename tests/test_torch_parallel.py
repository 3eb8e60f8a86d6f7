"""Port parity: the sharded renderers of ``gmpi_tpu_torch.parallel``.

The port's five functions of ``parallel/render.py`` run in ``gloo`` process
groups of 2, 3 and 4 ranks on the CPU (one spawn of each, shared by the
cases: ``tests/_torch_dist_child.py``), on the gather route, the fused route
(the kernels' plain versions on the CPU) and the banded route (128^2), with
and without disparity.  Each is held against the JAX package's function of
the same name (``gmpi_tpu.parallel.render``, gather route) on as many of the
8 virtual CPU devices of ``tests/conftest.py``, on the same numpy inputs:
outputs within 5e-4 (measured: ~1e-6 gather, ~4e-6 fused), and the ``rgba``
gradient of ``sum(color * cot) + sum(depth * cot_d)`` within 1e-3 of its
largest entry.  Every rank returns the same image and the same full gradient.
This mirrors ``tests/test_parallel.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gmpi_tpu.core import camera as jcam
from gmpi_tpu.core import geometry as jgeom
from gmpi_tpu.core import poses as jposes
from gmpi_tpu.parallel import render as jpr
from gmpi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tests import _torch_dist_child as child

TOL = 5e-4
GRAD_REL = 1e-3

# (world, case) -> the JAX function and mesh it is held against
CASES = {
    (2, "tile"): "tile", (2, "tile_disp"): "tile", (2, "tile_fused"): "tile",
    (2, "plane"): "plane", (2, "plane_disp"): "plane", (2, "plane_fused"): "plane",
    (2, "pipelined"): "pipelined", (2, "pipelined_fused"): "pipelined",
    (2, "tile_banded"): "tile_big", (2, "plane_banded"): "plane_big",
    (3, "plane"): "plane3",
    (4, "tile"): "tile", (4, "plane"): "plane", (4, "plane_disp"): "plane",
    (4, "plane_fused"): "plane", (4, "pipelined"): "pipelined",
    (4, "pipelined_fused"): "pipelined",
    (4, "plane_tile"): "plane_tile", (4, "plane_tile_fused"): "plane_tile",
}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        rgba=rng.random((2, 8, 4, 32, 32)).astype(np.float32),
        rgba3=rng.random((2, 6, 4, 32, 32)).astype(np.float32),
        yaws=np.array([[-0.2], [0.2]], np.float32),
        pitches=np.array([[0.1], [-0.1]], np.float32),
        cot=rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
        cot_d=rng.standard_normal((2, 1, 32, 32)).astype(np.float32),
        rgba_big=rng.random((1, 4, 4, 128, 128)).astype(np.float32),
        yaws_big=np.array([[0.15]], np.float32),
        pitches_big=np.array([[0.05]], np.float32),
        cot_big=rng.standard_normal((1, 3, 128, 128)).astype(np.float32),
        cot_d_big=rng.standard_normal((1, 1, 128, 128)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Every rank's results of the render job, by world size."""
    out = {}
    for world in (2, 3, 4):
        work = tmp_path_factory.mktemp(f"render{world}")
        np.savez(work / "inputs.npz", **inputs)
        out[world] = child.spawn("render", world, str(work))
    return out


def _jax_setup(rgba, yaws, pitches):
    geom = jgeom.build_plane_geometry(n_planes=rgba.shape[1], **child.GEOM_KW)
    c2w = jposes.c2w_from_yaw_pitch(jnp.asarray(yaws), jnp.asarray(pitches), 1.0, 1.0)
    res = rgba.shape[-1]
    return jnp.asarray(geom.dhw), jcam.generate_rays(jcam.intrinsics_from_fov(12.6, res, res),
                                                     c2w)


def _jax_ref(kind, world, inputs):
    """(color, depth, disp, grad) of the JAX package's sharded function."""
    devs = jax.devices()
    big = kind.endswith("_big")
    rgba = inputs["rgba_big" if big else "rgba3" if kind == "plane3" else "rgba"]
    sfx = "_big" if big else ""
    dhw, (ray, eye, z) = _jax_setup(rgba, inputs["yaws" + sfx], inputs["pitches" + sfx])
    cot, cot_d = jnp.asarray(inputs["cot" + sfx]), jnp.asarray(inputs["cot_d" + sfx])
    if kind.startswith("plane_tile"):
        mesh = jax_make_mesh([2, 2], ("plane", "tile"), devices=devs[:4])
        fn = lambda x: jpr.render_mpi_plane_tile_sharded(mesh, x, dhw, ray, eye, z,  # noqa
                                                         with_disp=True)
    elif kind.startswith("tile"):
        mesh = jax_make_mesh([world], ("tile",), devices=devs[:world])
        fn = lambda x: jpr.render_mpi_tile_sharded(mesh, x, dhw, ray, eye, z,  # noqa
                                                   with_disp=True)
    elif kind == "pipelined":
        mesh = jax_make_mesh([world], ("plane",), devices=devs[:world])
        fn = lambda x: jpr.render_mpi_plane_sharded_pipelined(  # noqa
            mesh, x, dhw, ray, eye, z, n_sub=2, with_disp=True)
    else:
        mesh = jax_make_mesh([world], ("plane",), devices=devs[:world])
        fn = lambda x: jpr.render_mpi_plane_sharded(mesh, x, dhw, ray, eye, z,  # noqa
                                                    with_disp=True)

    def loss(x):
        out = fn(x)
        return jnp.sum(out.color * cot) + jnp.sum(out.depth * cot_d)

    x = jnp.asarray(rgba)
    out = jax.jit(fn)(x)
    grad = jax.jit(jax.grad(loss))(x)
    return tuple(np.asarray(a) for a in (out.color, out.depth, out.disp, grad))


@pytest.fixture(scope="module")
def jax_refs(inputs):
    cache = {}

    def get(kind, world):
        if (kind, world) not in cache:
            cache[kind, world] = _jax_ref(kind, world, inputs)
        return cache[kind, world]

    return get


def test_children_import_no_jax(runs):
    for world, results in runs.items():
        for r in results:
            assert r["modules"] == [], (world, r["modules"])


@pytest.mark.parametrize("world,case", sorted(CASES), ids=[f"{w}-{c}" for w, c in sorted(CASES)])
def test_sharded_render_matches_jax(runs, jax_refs, world, case):
    results = runs[world]
    mine = results[0][case]
    color, depth, disp, grad = jax_refs(CASES[world, case], world)
    for name, ref in (("color", color), ("depth", depth), ("disp", disp)):
        got = mine[name]
        if got is None:
            assert name == "disp" and not case.endswith(("_disp", "fused", "pipelined",
                                                         "plane_tile"))
            continue
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= TOL, (case, name, err)
    g = mine["grad"].numpy()
    assert float(np.abs(g - grad).max()) <= GRAD_REL * float(np.abs(grad).max()), case
    for other in results[1:]:  # every rank: the whole image and the whole gradient
        for name in ("color", "depth", "grad"):
            np.testing.assert_array_equal(other[case][name].numpy(), mine[name].numpy())


def test_banded_route_used_real_bands(runs):
    """The banded cases ran the tile-banded warp (bands found from the
    grid at 128^2, not the per-pixel gather)."""
    assert all(b > 0 for b in runs[2][0]["bands"])
