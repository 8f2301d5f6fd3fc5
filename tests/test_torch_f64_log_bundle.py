"""The float64 build's trace kernels with the event log (K11) and from a
host bundle (K8-host), through the g++ ``-DPVT_F64`` host build of their
device code.

``tracer_f64``'s launches with the log, and from a bundle with recorders,
meshes or the log, are eleven instantiations of ``trace_kernel``
(``<tally, log, mesh, 0, 0, bundle, 0>``). Each case here runs one of them,
or the designed instantiation beside it without the log, through
pvt_trace's loop (``trace_warps``: emulated warps, one step a turn, as the
card's launch picks its step) and holds its fates, recorder tallies and
every log record, photon by photon, to the float64 eager twin's.
"""
import ctypes

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.emit import emit_bundle  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import (lsc_slab, lsc_slab_host, lsc_slab_recorders,  # noqa: E402
                                      mesh_lsc)

cap_threads()
F64 = torch.float64
# scene, photons, whether it starts from a host bundle: the bench slab
# (the simulate default's <0,1,0>), the slab with 4 recorders (<1,1,0>, as
# the CLI's and the studio's scenes), the mesh LSC (<1,1,1>, its history
# run) and the host-lit slab with 4 recorders (<1,0,0,..,1>, <1,1,0,..,1>).
SCENES = {
    "slab": (lsc_slab, 1 << 11, False),
    "slab-R4": (lambda: lsc_slab_recorders(4), 1 << 11, False),
    "mesh_lsc": (mesh_lsc, 1 << 10, False),
    "host-R4": (lambda: lsc_slab_host(n_rec=4), 1 << 11, True),
}
EVENTS = 128


@pytest.fixture(scope="module")
def h(tmp_path_factory):
    """tracer.cuh built for the host in float64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"), f64=True)


def _warp_run(h, st, seed, n, every, bundle):
    """Photons [0, n) through the host model of pvt_trace's loop on 4
    emulated warps, the log of every `every`-th photon (none for 0):
    (fates, tallies, log)."""
    R = max(st["meta"]["n_rec"], 1)
    t = {"fates": torch.zeros(11, dtype=torch.int64), "cross": torch.zeros(R, dtype=torch.int64),
         "distinct": torch.zeros(R, dtype=torch.int32), "sums": torch.zeros(8 * R, dtype=F64),
         "bins": torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64),
         "sums64": torch.zeros(8 * R, dtype=F64), "out": torch.zeros(3, dtype=torch.int64)}
    log, desc = kernels.empty_log(n, every, EVENTS, 0, "cpu", fill=False, dtype=F64)
    bdesc = kernels._Bundle(bundle.data_ptr(), n, 0) if bundle is not None else None
    h.h_trace_warp(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0], seed[1], 0, n, 4,
        ctypes.byref(desc), t["fates"].data_ptr(), t["cross"].data_ptr(), t["sums"].data_ptr(),
        t["distinct"].data_ptr(), t["bins"].data_ptr(), t["sums64"].data_ptr(), None, 0,
        st["meta"]["n_comps"], None, None, None, None, None, 0,
        ctypes.byref(bdesc) if bdesc is not None else None, t["out"].data_ptr(), None)
    t["sums"] = (t["sums64"] + t["sums"]).view(R, 8)
    return t.pop("fates"), t, log if every else None


@pytest.mark.parametrize("every", [0, 1], ids=["no-log", "log"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_f64_log_and_bundle_instantiations_match_twin_on_host(h, scene, every):
    """One float64 instantiation with the log or a bundle (or its log-free
    neighbour) in pvt_trace's loop against the float64 eager twin on the
    same photons: fates, crossings, distinct rays and bins equal, the
    moment sums within ``check.sums_allow_f64``, and with the log each
    photon's record count and every record's ints equal, its floats within
    ``check.F64_RTOL``."""
    make, n, from_host = SCENES[scene]
    built = make()
    st = tables.scene_tensors(compile_scene(built), dtype=F64)
    bundle = None
    if from_host:
        np.random.seed(21)
        bundle = torch.from_numpy(tracer.bundle_rows(*emit_bundle(built, n)[:3], np.float64))
    seed = rng.key_words(21)
    fates, got, log = _warp_run(h, st, seed, n, every, bundle)
    ref_fates, _, ref, ref_log = tracer.trace_eager(st, seed, n, 0, 512, record_every=every,
                                                    max_events=EVENTS, bundle=bundle)
    assert int(fates.sum()) == n and torch.equal(fates, ref_fates), (fates, ref_fates)
    R = st["meta"]["n_rec"]
    for name in ("cross", "distinct"):
        assert torch.equal(got[name][:R].long(), ref[name][:R].long()), name
    assert torch.equal(got["bins"][:st["meta"]["total_bins"]], ref["bins"])
    if R:
        assert int(got["distinct"].sum()) > 0
        allow = check.sums_allow_f64(ref["sums"][:R], ref["distinct"][:R].double())
        assert bool(((got["sums"][:R] - ref["sums"][:R]).abs() <= allow).all())
    if every:
        assert torch.equal(log["counts"], ref_log["counts"]) and int(log["counts"].min()) >= 2
        ints, floats = check.dense_log(log)
        assert torch.equal(ints, ref_log["ints"])
        torch.testing.assert_close(floats, ref_log["floats"], rtol=check.F64_RTOL,
                                   atol=check.F64_ATOL)
