"""K10: triangle meshes in the port against the JAX package.

On the CPU:

* ``geometry.mesh_nearest_two`` against the JAX ``_mesh_nearest_two``,
  called directly on the same random rays, on the hex plate (24
  triangles, the JAX package's unrolled branch) and on the tessellated
  slab (140, its ``fori_loop`` branch): equal in float64, within 1e-6 in
  float32;
* the device code's ``mesh_nearest_two`` (``tracer.cuh``, built for the
  host) against the twin, and a host-built trace of ``mesh_small``;
* the scene functions: ``scenes.mesh_lsc`` is the scene of
  ``examples/mesh_lsc.py``;
* the port's own consistency: the mesh path gives the same fates and
  tallies whether or not it keeps a log, and whatever its lane count.

``simulate`` of ``mesh_small`` against the JAX package, log and all, is
in ``test_torch_eventlog.py``. The full-width mesh LSC against the JAX
package is ``slow`` (its JAX compile alone takes minutes on a CPU); on
the card the kernels are held to the twins by ``test_torch_kernels.py``
(``gpu``).
"""
import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene as jax_compile_scene  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, geometry, rng, simulate, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import mesh_lsc, mesh_slab_fine, mesh_small  # noqa: E402

cap_threads()
N_RAYS = 1 << 12
MESHES = {"hex_plate": mesh_lsc, "fine_slab": mesh_slab_fine}
# float32 against float32: the same operations; XLA and PyTorch may round
# a product or a division differently in the last bit.
F32_RTOL = 1e-6


def _mesh_rays(compiled, seed):
    """Random rays (float64 numpy, [3, N] each) in the local frame of the
    scene's mesh node: origins in its bounding box grown by a fifth,
    isotropic directions."""
    v0, e1, e2, _ = compiled.mesh_data[1]
    corners = np.concatenate([v0, v0 + e1, v0 + e2])
    lo, hi = corners.min(0), corners.max(0)
    lo, hi = lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo)
    gen = np.random.default_rng(seed)
    o = lo[:, None] + (hi - lo)[:, None] * gen.uniform(size=(3, N_RAYS))
    d = gen.normal(size=(3, N_RAYS))
    return o, d / np.linalg.norm(d, axis=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_nearest_two_matches_jax(name, dtype):
    compiled = compile_scene(MESHES[name]())
    st = tables.scene_tensors(compiled, dtype=torch.float64 if dtype == np.float64
                              else torch.float32)
    tri, eps = kernels.mesh_rows(st, 1)
    assert (tri.shape[0] > 96) == (name == "fine_slab")  # both JAX branches
    o, d = (v.astype(dtype) for v in _mesh_rays(compiled, 4))
    consts = tuple(np.asarray(a, dtype=dtype) for a in compiled.mesh_data[1])
    ref = jt._mesh_nearest_two(consts, tuple(jnp.asarray(v) for v in o),
                               tuple(jnp.asarray(v) for v in d), dtype(eps))
    got = geometry.mesh_nearest_two(tri, tuple(torch.from_numpy(v) for v in o),
                                    tuple(torch.from_numpy(v) for v in d), eps)
    t1, t2, cnt = (np.asarray(ref[k]) for k in range(3))
    nrm = np.stack([np.asarray(v) for v in ref[3:]])
    g1, g2, gc = (got[k].numpy() for k in range(3))
    gn = torch.stack(got[3]).numpy()
    # Rays start inside (one hit) and outside (two or none).
    assert (cnt == 1).sum() > N_RAYS // 8 and (cnt >= 2).sum() > N_RAYS // 16
    if dtype == np.float64:
        for r, g in ((t1, g1), (t2, g2), (cnt, gc), (nrm, gn)):
            np.testing.assert_array_equal(g, r)
        return
    same = gc == cnt
    assert (~same).sum() <= 2
    for r, g in ((t1, g1), (t2, g2)):
        np.testing.assert_allclose(g[same], r[same], rtol=F32_RTOL, atol=0)
    np.testing.assert_array_equal(gn[:, same], nrm[:, same])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("staged", [0, 1], ids=["device_memory", "staged"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_device_mesh_nearest_two_matches_twin_on_host(host_lib, name, staged):
    """mesh_lane (the body of pvt_mesh; mesh_nearest_two inlined, as the
    mesh instantiations of pvt_trace take it), host-built without FMA
    contraction, equals the float32 twin ray for ray, reading the
    triangles where they lie and from a staged copy, as a block reads its
    shared one."""
    st = tables.scene_tensors(compile_scene(MESHES[name]()), dtype=torch.float32)
    tri, eps = kernels.mesh_rows(st, 1)
    o, d = check.mesh_rays(st, 1, N_RAYS, seed=7)
    t1, t2, nrm = torch.empty(N_RAYS), torch.empty(N_RAYS), torch.empty((N_RAYS, 3))
    cnt = torch.empty(N_RAYS, dtype=torch.int32)
    host_lib.h_mesh(tri.data_ptr(), tri.shape[0], staged, eps, o.data_ptr(), d.data_ptr(),
                    N_RAYS, t1.data_ptr(), t2.data_ptr(), cnt.data_ptr(), nrm.data_ptr())
    ref = kernels.mesh(st, 1, o, d)
    assert int((ref[2] >= 1).sum()) > N_RAYS // 4
    for got, want in zip((t1, t2, cnt, nrm), ref):
        assert torch.equal(got, want)


def test_device_trace_of_mesh_scene_matches_twin_on_host(host_lib):
    st, seed = tables.scene_tensors(compile_scene(mesh_small())), rng.key_words(6)
    sc = kernels._scene(st, 1000, 0, float("inf"))
    _, no_log = kernels.empty_log(2048, 0, 128, 0, "cpu")
    fates = torch.zeros(11, dtype=torch.int64)
    host_lib.h_trace(ctypes.byref(sc), seed[0], seed[1], 0, 2048, ctypes.byref(no_log),
                     fates.data_ptr())
    ref = tracer.trace_eager(st, seed, 2048, lanes=512)[0]
    assert int(fates.sum()) == 2048 and int(ref[7]) > 0 and int(ref[4]) > 0
    assert int((fates - ref).abs().max()) <= 2, (fates.tolist(), ref.tolist())


def test_mesh_lsc_is_the_example_scene():
    path = Path(__file__).resolve().parent.parent / "examples" / "mesh_lsc.py"
    spec = importlib.util.spec_from_file_location("pvtrace_mesh_lsc", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    digest = jax_compile_scene(example.build_mesh_lsc()).content_digest
    assert jax_compile_scene(mesh_lsc(pvtrace_tpu)).content_digest == digest
    got = compile_scene(mesh_lsc())
    assert got.content_digest == digest
    assert len(got.mesh_data[1][0]) == 24 and got.n_recorders == 7


@pytest.mark.parametrize("make", [mesh_small, mesh_lsc], ids=["mesh_small", "mesh_lsc"])
def test_mesh_fates_do_not_depend_on_lanes_or_the_log(make):
    """The same photons with and without regeneration, and with a log
    large enough that no photon meets its event budget: the same fates
    and recorder tallies."""
    runs = [
        simulate(make(), 600, seed=8, record_every=every, max_events=4096, lanes=lanes,
                 dtype=np.float64, device="cpu", index_offset=3).data
        for lanes, every in ((None, 0), (64, 0), (64, 7))
    ]
    assert runs[0]["fates"][7] > 0
    for data in runs[1:]:
        for key in ("fates", "rec_distinct", "rec_crossings"):
            np.testing.assert_array_equal(data[key], runs[0][key])
        np.testing.assert_allclose(data["rec_sums"], runs[0]["rec_sums"], rtol=1e-12)
    # Photons 3..602: the multiples of 7 are 7..602, the ceil(600 / 7) = 86
    # slots, each with its GENERATE record and at least one more.
    counts = runs[2]["counts"]
    assert counts.shape == (86,) and counts.min() >= 2


def _assert_fates_and_tallies_match(ref, got, photons=4):
    ref, got = ref.data, got.data
    assert np.abs(got["fates"] - np.asarray(ref["fates"])).max() <= photons
    for key in ("rec_distinct", "rec_crossings"):
        assert np.abs(got[key] - np.asarray(ref[key])).max() <= photons, key


@pytest.mark.slow
@pytest.mark.parametrize("record_every", [0, 1])
def test_mesh_lsc_float64_matches_jax(record_every):
    """The full-width mesh LSC in float64 against the JAX package (its
    compile takes 77 s at record_every 0 and 198 s at 1 on a CPU)."""
    n = 4096 if record_every == 0 else 1024
    ref = jax_engine.simulate(mesh_lsc(pvtrace_tpu), n, seed=5, record_every=record_every,
                              dtype=np.float64, lanes=512)
    got = simulate(mesh_lsc(), n, seed=5, record_every=record_every, dtype=np.float64,
                   lanes=512, device="cpu")
    _assert_fates_and_tallies_match(ref, got)
    if record_every:
        same = (got.data["kind"] == np.asarray(ref.data["kind"])).all(1)
        assert same.sum() >= len(same) - 4
        np.testing.assert_array_equal(got.data["counts"][same], np.asarray(ref.data["counts"])[same])
    assert jax.config.read("jax_enable_x64")

