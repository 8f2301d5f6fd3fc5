"""K3/K4 per geometry: the port's forward hits and normals against JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pvtrace_tpu.engine import compiler as comp  # noqa: E402
from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu_torch.engine import geometry  # noqa: E402

torch.set_num_threads(1)
N = 4096
EPS = 2.2e-12
RTOL = 1e-12
GEOMETRIES = {
    "box": (comp.GEOM_BOX, (2.0, 1.0, 0.5)),
    "sphere": (comp.GEOM_SPHERE, (1.3, 0.0, 0.0)),
    "cylinder": (comp.GEOM_CYLINDER, (2.0, 0.7, 0.0)),
}


def _rays(seed):
    """Random origins in [-1.5, 1.5]^3 and unit directions; one ray in
    eight has its x direction zeroed and one in eight its z direction, to
    take the parallel branches."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(-1.5, 1.5, size=(3, N))
    d = gen.normal(size=(3, N))
    d[0, ::8] = 0.0
    d[2, 1::8] = 0.0
    d /= np.linalg.norm(d, axis=0)
    return o, d


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_intersect_matches_jax(name):
    gtype, params = GEOMETRIES[name]
    o, d = _rays(3)
    ref = jt._intersect_node_static(
        gtype, np.asarray(params), tuple(jnp.asarray(v) for v in o),
        tuple(jnp.asarray(v) for v in d), EPS,
    )
    got = geometry.intersect(
        gtype, list(params), tuple(torch.from_numpy(v) for v in o),
        tuple(torch.from_numpy(v) for v in d), EPS,
    )
    assert len(got) == len(ref)
    hits = 0
    for (rt, rv), (gt, gv) in zip(ref, got):
        rv, rt = np.asarray(rv), np.asarray(rt)
        np.testing.assert_array_equal(gv.numpy(), rv)
        np.testing.assert_allclose(gt.numpy()[rv], rt[rv], rtol=RTOL, atol=0)
        hits += int(rv.sum())
    assert hits > N // 8  # the comparison is not vacuous


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_local_normal_matches_jax(name):
    gtype, params = GEOMETRIES[name]
    o, d = _rays(4)
    # Points on the surface (first forward hit of each ray that has one)
    # and points anywhere.
    (t, valid) = next(
        (t, v) for t, v in jt._intersect_node_static(
            gtype, np.asarray(params), tuple(jnp.asarray(v) for v in o),
            tuple(jnp.asarray(v) for v in d), EPS,
        )
    )
    t = np.where(np.asarray(valid), np.asarray(t), 0.0)
    p = np.concatenate([o + t * d, o], axis=1)
    ref = jt._local_normal_static(gtype, np.asarray(params), tuple(jnp.asarray(v) for v in p))
    got = geometry.local_normal(gtype, list(params), tuple(torch.from_numpy(v) for v in p))
    for r, g in zip(ref, got):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=0)
