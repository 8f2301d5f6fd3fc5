"""Random nested and touching scenes in float32: crafted rays event by event
against the oracle, and the g++ host build of the device code against
the eager twin.

On every CPU seed (``_random_cases.CPU_SEEDS``, fixed before the
suite's first run):

* the index-matched copy (``random_scene(seed, matched=True)``): the
  crafted rays (from node centres at every nesting level, across the
  faces touching boxes share, from outside toward the nodes) through the
  bundle form of ``kernels.trace`` with ``record_every=1`` (the
  twin, on the CPU) against the oracle's ``step_forward``, record by
  record (``kernels.crafted.compare``), under the scene's
  own emit method and caps; then the same rays through the host build's
  ``trace_photon``, whose log must equal the twin's;
* the scene itself: ``emit_lane`` and six ``step_lane``s lane by
  lane, and the trace's fates at 4096 photons, against the twin
  (``_random_cases.assert_host_matches_twin``): the only way the
  tests reach the CUDA source on nested and touching geometry without a
  card.
"""
import pytest

from _random_cases import CPU_SEEDS, assert_host_matches_twin, assert_logs_equal, host_crafted
from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch.engine import compile_scene, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, crafted, host  # noqa: E402
from pvtrace_tpu_torch.scenes import random_scene  # noqa: E402

cap_threads()
F32 = torch.float32


@pytest.fixture(scope="module")
def h(tmp_path_factory):
    """tracer.cuh built for the host in float32 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_crafted_rays_match_oracle_float32(h, seed):
    built = random_scene(seed, matched=True)
    st = tables.scene_tensors(compile_scene(built.scene), dtype=F32)
    twin = crafted.trace_crafted(built, st, seed)
    counted = crafted.compare(built, twin, F32)
    assert counted["records"] >= len(built.rays[0])
    # Every pair of touching boxes has two crafted rays across its face.
    assert counted["shared"] >= 2 * (built.features["touching"] - 1)
    assert_logs_equal(host_crafted(h, built, st, seed), twin, F32, built.scale)


@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_host_build_matches_twin_float32(h, seed):
    assert_host_matches_twin(h, random_scene(seed), F32, seed)


def test_float32_repeats_a_crossing_after_a_long_free_path():
    """The reference fault the float32 engine meets (``kernels.crafted.repeats``;
    the JAX package's float32 engine alike, ``test_torch_random_jax.py``):
    seed 1's ray 5 reaches s0 after a free path of 26 cm and crosses its
    surface twice at the same point in float32, once in float64."""
    built = random_scene(1, matched=True)
    compiled = compile_scene(built.scene)
    for dtype, want in ((F32, [2]), (torch.float64, [])):
        log = crafted.trace_crafted(built, tables.scene_tensors(compiled, dtype=dtype), 1)
        got = crafted.engine_records(log, 5, compiled.node_names)
        assert crafted.repeats(got, 1e-3) == want, dtype
        assert got[1][1:4] == ("s0", "world", "s0")


def test_score_records_at_equal_index_crossings_on_host(h):
    """Seed 0's nested spheres and touching boxes share one n: the Fresnel
    partials of their crossings are 0 in exact arithmetic and rounding in
    float32 (``engine/score.py``: the floor of their slack). The host
    build's per-photon score records of 2**16 photons lie within the
    twin's bounds, none parted (two parted, photons 7479 and 32723,
    before the slack took the cancellation in)."""
    built = random_scene(0)
    st = tables.scene_tensors(compile_scene(built.scene), dtype=F32)
    n, words = 1 << 16, rng.key_words(0)
    fates, got = host.trace_scores(h, st, words, n)
    ref = tracer.trace_eager(st, words, n, lanes=1 << 14, score=True, per_photon=True,
                             **crafted.options(built))
    assert built.options["maxsteps"] == 1000 and torch.equal(fates, ref[0])
    assert check.compare_score_records(got, ref[2], fates, n, 0)["parted"] == 0
