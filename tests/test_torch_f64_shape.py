"""The float64 build's trace kernels with recorders (K9) and meshes (K10):
their block shape and shared budget, and pvt_trace's loop on the scenes
that launch them, through the g++ host build of the device code.

On the card these instantiations take blocks of 128 threads, five an SM,
and a 44 KB budget a block (``tracer.cuh::trace_shape``), from a host
bundle too; with the event log blocks of 128, four an SM, within 56 KB;
the float64 main path (and the bundle's launch that runs its step), and
every float32 instantiation, two blocks of 256 and 96 KB. The host
build's ``h_layout`` gives the device code's placement and block for a
launch; ``trace_warps`` is
pvt_trace's loop over emulated warps, whatever a block's size, held here
to the float64 eager twin.
"""
import types

import pytest

from _random_cases import host_tallies
from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, crafted, host  # noqa: E402
from pvtrace_tpu_torch.scenes import (lsc_slab, lsc_slab_heatmap, lsc_slab_recorders,  # noqa: E402
                                      mesh_lsc, mesh_slab_fine, random_scene)

cap_threads()
F64 = torch.float64
KB = 1024


@pytest.fixture(scope="module")
def h(tmp_path_factory):
    """tracer.cuh built for the host in float64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"), f64=True)


def _tensors(make):
    return tables.scene_tensors(compile_scene(make()), dtype=F64)


# Each scene's placement in a block of the recorder or mesh launch (44 KB):
# shared_bins, shared_cheb, shared_tris. 256 recorders' tallies and bins
# (69.6 KB) and the heatmap's bins (164 KB) stay in device memory; the
# fine slab's 140 triangles (13.4 KB) fit.
PLACED = {
    "R4": (lambda: lsc_slab_recorders(4), (1, 1, 0)),
    "R32": (lambda: lsc_slab_recorders(32), (1, 1, 0)),
    "R256": (lambda: lsc_slab_recorders(256), (0, 1, 0)),
    "heatmap": (lsc_slab_heatmap, (0, 1, 0)),
    "mesh_lsc": (mesh_lsc, (1, 1, 1)),
    "fine_slab": (mesh_slab_fine, (0, 1, 1)),
}


@pytest.mark.parametrize("scene", list(PLACED))
def test_f64_recorder_and_mesh_launches_take_their_block(h, scene):
    """A float64 launch with recorders or meshes and neither scores nor
    the event log takes blocks of 128 threads within 44 KB, from a host
    bundle too, and places its bins, K5a table and triangles by that
    budget; with the log the same scene takes blocks of 128, four an SM,
    within 56 KB, and places them alike (256 recorders' bins, 69.6 KB,
    in device memory); ``kernels.trace_shape`` says the same blocks, and
    the float32 build keeps 256 threads for every launch."""
    make, placed = PLACED[scene]
    st = _tensors(make)
    meta = st["meta"]
    got = kernels.trace_layout(st, entry=h.h_layout)
    assert got["block"] == 128 and got["shared_bytes"] <= 44 * KB, got
    assert (got["shared_bins"], got["shared_cheb"], got["shared_tris"]) == placed, got
    assert kernels.trace_shape(meta, F64) == (128, 5)
    for log, bundle in ((True, False), (False, True), (True, True)):
        other = kernels.trace_layout(st, entry=h.h_layout, log=log, bundle=bundle)
        assert other["block"] == 128 and other["shared_bytes"] <= (56 if log else 44) * KB, other
        assert (other["shared_bins"], other["shared_cheb"], other["shared_tris"]) == placed, other
        assert kernels.trace_shape(meta, F64, log=log, bundle=bundle) == ((128, 4) if log
                                                                           else (128, 5))
    assert kernels.trace_shape(meta, torch.float32) == (256, 2)
    slab = kernels.trace_layout(_tensors(lsc_slab), entry=h.h_layout)
    assert slab["block"] == 256
    assert kernels.trace_layout(_tensors(lsc_slab), entry=h.h_layout, bundle=True)["block"] == 256


# pvt_trace's loop against the twin: the slab with 32 recorders, the mesh
# LSC, and the two random scenes with a mesh whose recorders count rays
# at 2**12 photons (seed 11's tetrahedron with facet recorders, seed 19's
# beside a cylinder), neither with coincident faces.
LOOP = {
    "R32": (lambda: lsc_slab_recorders(32), 1 << 11),
    "mesh_lsc": (mesh_lsc, 1 << 11),
    "random-11": (11, 1 << 12),
    "random-19": (19, 1 << 12),
}


@pytest.mark.parametrize("case", list(LOOP))
def test_f64_warp_loop_matches_twin_on_host(h, case):
    """The float64 host build's model of pvt_trace's loop (``trace_warps``,
    4 emulated warps) on a scene whose launch takes the recorder or mesh
    block, against the float64 eager twin: fates, crossings, distinct
    rays and bins equal, the moment sums within ``check.sums_allow_f64``."""
    make, n = LOOP[case]
    if isinstance(make, int):
        built, seed = random_scene(make), make
        assert "tetrahedron" in built.features["geometries"]
        assert built.features["recorders"] and not built.coincident
    else:
        built = types.SimpleNamespace(scene=make(), options={
            "maxsteps": 1000, "emit_method": "kT", "maxpathlength": None})
        seed = 5
    st = tables.scene_tensors(compile_scene(built.scene), dtype=F64)
    fates, got = host_tallies(h, built, st, seed, n, warps=4)
    ref_fates, _, ref, _ = tracer.trace_eager(st, rng.key_words(seed), n, lanes=1 << 10,
                                              **crafted.options(built))
    assert int(fates.sum()) == n and torch.equal(fates, ref_fates), (fates, ref_fates)
    R = st["meta"]["n_rec"]
    assert int(got["distinct"].sum()) > 0
    for name in ("cross", "distinct"):
        assert torch.equal(got[name][:R].long(), ref[name][:R].long()), name
    assert torch.equal(got["bins"][:st["meta"]["total_bins"]], ref["bins"])
    allow = check.sums_allow_f64(ref["sums"][:R], ref["distinct"][:R].double())
    assert bool(((got["sums"][:R] - ref["sums"][:R]).abs() <= allow).all())
