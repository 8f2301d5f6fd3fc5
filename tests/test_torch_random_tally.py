"""Random nested and touching scenes: K9's recorder tallies in float64,
the g++ host build of the device code against the eager twin.

On every CPU seed whose scene has recorders or touching boxes
(``_random_cases.CPU_SEEDS``), with the probe recorders on the faces
touching boxes share (``random_scene(seed, probes=True)``), 2**13 photons
under the scene's options: fates equal, the integer tallies equal and the
moment sums within ``check.sums_allow_f64``, off the nodes with
coincident faces; on them, whose recorders' counts rounding moves, each
probe pair's crossings equal and every tally within the shared-face
crossings (``check.hold_tallies``).
"""
import pytest

from _random_cases import CPU_SEEDS, host_tallies
from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch.engine import compile_scene, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, crafted, host  # noqa: E402
from pvtrace_tpu_torch.scenes import random_scene  # noqa: E402

cap_threads()
F64 = torch.float64


@pytest.fixture(scope="module")
def h(tmp_path_factory):
    """tracer.cuh built for the host in float64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"), f64=True)


RECORDER_SEEDS = [s for s in CPU_SEEDS
                  if random_scene(s).features["recorders"] or random_scene(s).coincident]


@pytest.mark.parametrize("seed", RECORDER_SEEDS)
def test_host_build_recorders_match_twin_float64(h, seed):
    """K9 on nested and touching nodes: the host build's recorder tallies
    of 2**13 photons against the twin's, integers equal and moment sums
    within ``check.sums_allow_f64``, off the nodes with coincident faces;
    on them (rounding picks which of the two faces a crossing hits) each
    probe pair's crossings equal and each tally within the shared-face
    crossings (``check.hold_tallies``). The angle moments' part of that
    bound is new: seed 11's near-normal crossings put its angle sums at
    1.9e3 times the relative bound alone."""
    built = random_scene(seed, probes=True)
    compiled = compile_scene(built.scene)
    st = tables.scene_tensors(compiled, dtype=F64)
    n = 1 << 13
    fates, got = host_tallies(h, built, st, seed, n)
    ref_fates, _, ref, _ = tracer.trace_eager(st, rng.key_words(seed), n, lanes=1 << 11,
                                              **crafted.options(built))
    assert torch.equal(fates, ref_fates)
    faces = crafted.coincident(built, compiled)
    diffs, _, _ = check.hold_tallies(got, ref, st, 0, "host build", **faces)
    assert diffs == {"distinct": 0, "cross": 0, "bins": 0}
    R, on = st["meta"]["n_rec"], check.coincident_recorders(st, faces["coincident"])[0]
    allow = check.sums_allow_f64(ref["sums"][:R], ref["distinct"][:R].double())
    assert bool(((got["sums"][:R] - ref["sums"][:R]).abs() <= allow)[~on].all())
