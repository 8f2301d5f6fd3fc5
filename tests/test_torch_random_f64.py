"""Random nested and touching scenes in float64: crafted rays event by event
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

from pvtrace_tpu_torch.engine import compile_scene, tables  # noqa: E402
from pvtrace_tpu_torch.kernels import crafted, host  # noqa: E402
from pvtrace_tpu_torch.scenes import random_scene  # noqa: E402

cap_threads()
F64 = torch.float64


@pytest.fixture(scope="module")
def h(tmp_path_factory):
    """tracer.cuh built for the host in float64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"), f64=True)


@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_crafted_rays_match_oracle_float64(h, seed):
    built = random_scene(seed, matched=True)
    st = tables.scene_tensors(compile_scene(built.scene), dtype=F64)
    twin = crafted.trace_crafted(built, st, seed)
    counted = crafted.compare(built, twin, F64)
    assert counted["records"] >= len(built.rays[0]) and counted["engine"] == 0
    # Every pair of touching boxes has two crafted rays across its face.
    assert counted["shared"] >= 2 * (built.features["touching"] - 1)
    assert_logs_equal(host_crafted(h, built, st, seed), twin, F64, built.scale)


@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_host_build_matches_twin_float64(h, seed):
    assert_host_matches_twin(h, random_scene(seed), F64, seed)


def test_oracle_repeats_a_crossing_far_from_its_start():
    """The reference fault the crafted rays meet in the oracle
    (``kernels.crafted.repeats``): seed 0's ray 11 starts 32 cm from the
    origin and crosses s0's surface once in the engine, twice in the
    oracle, at the same point; the comparison leaves the repeat out."""
    built = random_scene(0, matched=True)
    st = tables.scene_tensors(compile_scene(built.scene), dtype=F64)
    raw = crafted.oracle_records(built, built.rays[0][11], built.rays[1][11], 1000)
    assert crafted.repeats(raw, 1e-9 * built.scale) == [2]
    assert [r[1] for r in raw[1:3]] == ["s0", "s0"]
    log = crafted.trace_crafted(built, st, 0)
    assert int(log[2][11]) == len(raw) - 1
    names = compile_scene(built.scene).node_names
    assert crafted.repeats(crafted.engine_records(log, 11, names), 1.0) == []
