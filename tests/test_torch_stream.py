"""Streams and checkpoints: the port's ``simulate_stream`` and
``simulate_checkpointed`` against its own single run and the JAX
package's.

On ``scenes.absorbing_box`` (the JAX package's
``tests/test_checkpoint.py`` scene: 2 recorders, a 40-bin histogram), on
the CPU in float64, record_every=0:

* no regeneration, port against port: 900 photons in bundles of 250,
  seed 17; the stream's union equals one ``simulate``, integer tallies
  bit for bit (``tests/test_engine.py``'s exact-union test);
* regeneration, port against JAX: 1000 photons in bundles of 400,
  lanes=128, seed 23; the port's stream against the JAX package's
  ``simulate_stream``. Both trace the same photons in float64, so their
  integers are equal but for photons whose paths part by one ulp: at most
  PARTED of a run; each moves a fate from one count to another and, on
  this scene, at most one crossing of each recorder;
* the checkpoint cases of ``tests/test_checkpoint.py`` on the port, with
  the topology case over a gloo world of two processes (this file run as a
  script, once per rank, from a module fixture), and a checkpoint of
  either package resumed by the other (one bundle of 400 of 1200, lanes
  128), against the other's uninterrupted run within the same allowance.

Every JAX run shares one compile: regeneration with no event log compiles
once for any budget above `lanes` (``pvtrace_tpu/engine/api.py:344-350``).

Run as a script (``python tests/test_torch_stream.py RANK WORLD PORT OUT
CKPT``), the file is one rank: it imports torch and the port only, joins
the gloo world at ``tcp://localhost:PORT``, runs its share of a
checkpointed run into CKPT and writes what it saw to OUT.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_threads import cap_threads

PARTED = 2
N_STREAM, B_STREAM, SEED_STREAM = 900, 250, 17
N_REGEN, B_REGEN, SEED_REGEN, LANES = 1000, 400, 23, 128
N_CKPT, B_CKPT = 1200, 200
N_CROSS, B_CROSS, SEED_CROSS = 1200, 400, 31
N_TOPO, B_TOPO, SEED_TOPO = 1200, 200, 17
INTS = ("fates", "rec_distinct", "rec_crossings", "rec_bins")
F64 = dict(dtype=np.float64, record_every=0)




def _scene(ns=None):
    from pvtrace_tpu_torch.scenes import absorbing_box

    return absorbing_box(ns)


def _ints(state):
    """An AccumulatedResult's integer tallies under simulate's data keys."""
    return {"fates": state._fates, "rec_distinct": state._distinct,
            "rec_crossings": state._crossings, "rec_bins": state._bins}


def _union(stream):
    """The summed integer tallies of a stream and its last `traced`."""
    acc, traced = None, 0
    for result, traced in stream:
        part = {k: np.asarray(result.data[k], dtype=np.int64) for k in INTS}
        acc = part if acc is None else {k: acc[k] + part[k] for k in INTS}
    return acc, traced


def _assert_within_parted(got, ref):
    """Integer tallies of two packages' runs of the same photons: fates
    within 2 * PARTED in all (a parted photon moves one count to another),
    every recorder entry within PARTED."""
    assert int(np.abs(np.asarray(got["fates"]) - ref["fates"]).sum()) <= 2 * PARTED
    for k in INTS[1:]:
        assert np.asarray(got[k]).shape == np.asarray(ref[k]).shape, k
        assert int(np.abs(np.asarray(got[k]) - ref[k]).max(initial=0)) <= PARTED, k


def _tallies(result):
    """``tests/test_checkpoint.py::tallies``: each recorder's rays,
    crossings and first histogram."""
    out = {}
    for name, recorder in result.recorders.items():
        counts = recorder.histogram(0)[1] if recorder.spec.histograms else None
        out[name] = (recorder.rays, recorder.crossings,
                     None if counts is None else counts.tolist())
    return out


def _rank_main(rank, world, port, out_path, ckpt):
    """One rank of a gloo world on the CPU: three bundles of a
    checkpointed run into `ckpt` (rank 0 writes it), and the refusal of a
    bundle the mesh does not divide."""
    from pvtrace_tpu_torch.engine import simulate_checkpointed
    from pvtrace_tpu_torch.parallel import (
        init_distributed,
        make_photon_mesh,
        shutdown_distributed,
    )

    cap_threads()
    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                     rank=rank, device="cpu")
    mesh = make_photon_mesh(device="cpu")
    partial = simulate_checkpointed(_scene(), N_TOPO, ckpt, bundle=B_TOPO, seed=SEED_TOPO,
                                    stop_after_bundles=3, mesh=mesh, device="cpu", **F64)
    try:
        simulate_checkpointed(_scene(), N_TOPO, None, bundle=B_TOPO - 1, seed=1, mesh=mesh,
                              device="cpu", **F64)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    shutdown_distributed()
    stray = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pvtrace_tpu"))
    with open(out_path, "w") as fh:
        json.dump({"rank": rank, "traced": partial.traced, "complete": partial.complete,
                   "ints": {k: v.tolist() for k, v in _ints(partial).items()},
                   "refusal": refusal, "stray_modules": stray}, fh)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    sys.exit(0)

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu_torch import engine  # noqa: E402
from pvtrace_tpu_torch.engine import checkpoint  # noqa: E402

cap_threads()
CPU = dict(device="cpu", **F64)


# -- the JAX package's runs, one compile ----------------------------------


@pytest.fixture(scope="module")
def port_partial(tmp_path_factory):
    """A port checkpoint of one bundle of B_CROSS (of N_CROSS), seed
    SEED_CROSS, lanes LANES, for the JAX package to resume."""
    path = str(tmp_path_factory.mktemp("port") / "run.npz")
    state = engine.simulate_checkpointed(_scene(), N_CROSS, path, bundle=B_CROSS,
                                         seed=SEED_CROSS, stop_after_bundles=1, lanes=LANES,
                                         **CPU)
    assert state.traced == B_CROSS and not state.complete
    return path


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, port_partial):
    """The JAX package's stream with regeneration, its checkpoint of one
    bundle, its uninterrupted checkpointed run, and its resume of the
    port's checkpoint."""
    scene = _scene(pvtrace_tpu)
    out = {"stream": _union(jax_engine.simulate_stream(
        scene, N_REGEN, bundle=B_REGEN, seed=SEED_REGEN, lanes=LANES, **F64))}
    path = str(tmp_path_factory.mktemp("jax") / "run.npz")
    cross = dict(bundle=B_CROSS, seed=SEED_CROSS, lanes=LANES, **F64)
    partial = jax_engine.simulate_checkpointed(scene, N_CROSS, path, stop_after_bundles=1,
                                               **cross)
    assert partial.traced == B_CROSS
    out["partial"] = path
    out["full"] = _ints(jax_engine.simulate_checkpointed(scene, N_CROSS, None, **cross))
    resumed = jax_engine.simulate_checkpointed(scene, N_CROSS, port_partial, **cross)
    assert resumed.complete
    out["resumed_port"] = _ints(resumed)
    return out


# -- streams --------------------------------------------------------------


def test_stream_union_equals_one_run():
    """No regeneration (one lane a photon): the union of bundles of 250
    equals one run of 900, integer tallies bit for bit."""
    scene = _scene()
    single = engine.simulate(scene, N_STREAM, seed=SEED_STREAM, lanes=None, **CPU)
    acc, traced = _union(engine.simulate_stream(scene, N_STREAM, bundle=B_STREAM,
                                                seed=SEED_STREAM, lanes=None, **CPU))
    assert traced == N_STREAM
    for k in INTS:
        np.testing.assert_array_equal(acc[k], single.data[k], err_msg=k)
    assert int(acc["rec_distinct"][0]) > 0


def test_stream_with_regeneration_matches_jax(jax_runs):
    scene = _scene()
    acc, traced = _union(engine.simulate_stream(scene, N_REGEN, bundle=B_REGEN,
                                                seed=SEED_REGEN, lanes=LANES, **CPU))
    ref, ref_traced = jax_runs["stream"]
    assert traced == ref_traced == N_REGEN
    _assert_within_parted(acc, ref)
    single = engine.simulate(scene, N_REGEN, seed=SEED_REGEN, lanes=LANES, **CPU)
    for k in INTS:
        np.testing.assert_array_equal(acc[k], single.data[k], err_msg=k)


def test_stream_yields_bundles_at_their_global_offsets():
    """Each bundle traces the photon ids that follow the previous
    bundle's: it equals one ``simulate`` at its global start."""
    scene = _scene()
    got = []
    for r, traced in engine.simulate_stream(scene, 500, bundle=200, seed=3, **CPU):
        start = traced - len(r.sources)
        alone = engine.simulate(scene, len(r.sources), seed=3, index_offset=start, **CPU)
        for k in INTS:
            np.testing.assert_array_equal(r.data[k], alone.data[k], err_msg=f"{k} at {start}")
        got.append((len(r.sources), traced))
    assert got == [(200, 200), (200, 400), (100, 500)]


@pytest.mark.parametrize("case", ["ids-past-2**32-1", "no-photons", "bundle", "bundle-fraction"])
def test_stream_validates_when_called(case):
    """The call raises before any generator exists (the JAX package's
    raises at the first next())."""
    args = {"ids-past-2**32-1": dict(num_rays=2 ** 32),
            "no-photons": dict(num_rays=0),
            "bundle": dict(num_rays=1000, bundle=0),
            "bundle-fraction": dict(num_rays=1000, bundle=2.5)}[case]
    with pytest.raises(ValueError):
        engine.simulate_stream(_scene(), seed=1, device="cpu", **args)


# -- checkpoints ----------------------------------------------------------


def test_resume_equals_uninterrupted(tmp_path):
    scene = _scene()
    path = str(tmp_path / "run.npz")
    full = engine.simulate_checkpointed(scene, N_CKPT, None, bundle=B_CKPT, seed=42, **CPU)
    assert full.complete and full.traced == N_CKPT
    partial = engine.simulate_checkpointed(scene, N_CKPT, path, bundle=B_CKPT, seed=42,
                                           stop_after_bundles=2, **CPU)
    assert not partial.complete and partial.traced == 2 * B_CKPT
    resumed = engine.simulate_checkpointed(scene, N_CKPT, path, bundle=B_CKPT, seed=42, **CPU)
    assert resumed.complete and resumed.traced == N_CKPT
    assert _tallies(resumed) == _tallies(full)
    assert resumed.fate_counts() == full.fate_counts()
    np.testing.assert_allclose(resumed._sums, full._sums, rtol=1e-12)


def test_resume_without_bundle_takes_the_stored_one(tmp_path):
    scene = _scene()
    path = str(tmp_path / "run.npz")
    engine.simulate_checkpointed(scene, N_CKPT, path, bundle=B_CKPT, seed=8,
                                 stop_after_bundles=1, **CPU)
    with pytest.raises(ValueError, match="shape mismatch"):
        engine.simulate_checkpointed(scene, N_CKPT, path, bundle=2 * B_CKPT, seed=8, **CPU)
    resumed = engine.simulate_checkpointed(scene, N_CKPT, path, seed=8, **CPU)
    assert resumed.bundle == B_CKPT and resumed.complete
    full = engine.simulate_checkpointed(scene, N_CKPT, None, bundle=B_CKPT, seed=8, **CPU)
    assert _tallies(resumed) == _tallies(full)
    assert engine.simulate_checkpointed(scene, 10, None, seed=8, **CPU).bundle == \
        checkpoint.DEFAULT_BUNDLE == 16_000_000


def test_checkpoint_rejects_wrong_scene(tmp_path):
    path = str(tmp_path / "run.npz")
    engine.simulate_checkpointed(_scene(), 400, path, bundle=B_CKPT, seed=1,
                                 stop_after_bundles=1, **CPU)
    other = _scene()
    other.root.children[0].geometry.material.refractive_index = 1.7
    with pytest.raises(ValueError, match="different scene"):
        engine.simulate_checkpointed(other, 400, path, bundle=B_CKPT, seed=1, **CPU)


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    scene = _scene()
    path = str(tmp_path / "run.npz")
    engine.simulate_checkpointed(scene, 400, path, bundle=B_CKPT, seed=1,
                                 stop_after_bundles=1, **CPU)
    with pytest.raises(ValueError, match="shape mismatch"):
        engine.simulate_checkpointed(scene, 800, path, bundle=B_CKPT, seed=1, **CPU)
    with pytest.raises(ValueError, match="seed"):
        engine.simulate_checkpointed(scene, 400, path, bundle=B_CKPT, seed=2, **CPU)


def test_checkpoint_rejects_ids_past_2_32_before_any_work(tmp_path):
    path = str(tmp_path / "run.npz")
    for n in (2 ** 32, 0):
        with pytest.raises(ValueError):
            engine.simulate_checkpointed(_scene(), n, path, seed=1, **CPU)
    assert not os.path.exists(path)


def test_completed_checkpoint_is_a_noop(tmp_path):
    scene = _scene()
    path = str(tmp_path / "run.npz")
    first = engine.simulate_checkpointed(scene, 400, path, bundle=B_CKPT, seed=9, **CPU)
    mtime = os.stat(path).st_mtime_ns
    again = engine.simulate_checkpointed(scene, 400, path, bundle=B_CKPT, seed=9, **CPU)
    assert again.traced == 400 and os.stat(path).st_mtime_ns == mtime
    assert _tallies(again) == _tallies(first)


def test_checkpointed_score_gradients(tmp_path):
    from pvtrace_tpu_torch.light.event import Event

    scene = _scene()
    path = str(tmp_path / "score.npz")
    score = dict(bundle=B_CKPT, seed=3, score=True, **CPU)
    engine.simulate_checkpointed(scene, 800, path, stop_after_bundles=2, **score)
    resumed = engine.simulate_checkpointed(scene, 800, path, **score)
    full = engine.simulate_checkpointed(scene, 800, None, **score)
    fr, gr = resumed.fate_gradients()
    ff, gf = full.fate_gradients()
    assert fr == ff
    for event in gr:
        np.testing.assert_allclose(gr[event], gf[event], rtol=1e-12)
    # Absorber scale up => more NONRADIATIVE
    assert gr[Event.NONRADIATIVE][0] > 0


def test_score_checkpoint_mismatch_raises(tmp_path):
    scene = _scene()
    path = str(tmp_path / "noscore.npz")
    engine.simulate_checkpointed(scene, 400, path, bundle=B_CKPT, seed=1,
                                 stop_after_bundles=1, **CPU)
    with pytest.raises(ValueError, match="without score"):
        engine.simulate_checkpointed(scene, 400, path, bundle=B_CKPT, seed=1, score=True,
                                     **CPU)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The two ranks' reports, and the checkpoint they wrote."""
    tmp = tmp_path_factory.mktemp("world2")
    port, ckpt = _free_port(), str(tmp / "mesh-run.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    paths = [str(tmp / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
                               paths[r], ckpt], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text.decode(errors="replace")[-3000:]
    reports = []
    for path in paths:
        with open(path) as fh:
            reports.append(json.load(fh))
    return reports, ckpt


def test_checkpoint_is_topology_portable(world2):
    """Three bundles on a gloo world of two, resumed in one process
    without `bundle=`, equal one process's uninterrupted run."""
    reports, ckpt = world2
    scene = _scene()
    full = engine.simulate_checkpointed(scene, N_TOPO, None, bundle=B_TOPO, seed=SEED_TOPO,
                                        **CPU)
    for report in reports:
        assert report["traced"] == 3 * B_TOPO and not report["complete"]
        assert report["ints"] == reports[0]["ints"]
    resumed = engine.simulate_checkpointed(scene, N_TOPO, ckpt, seed=SEED_TOPO, **CPU)
    assert resumed.complete and resumed.bundle == B_TOPO
    assert _tallies(resumed) == _tallies(full)
    assert resumed.fate_counts() == full.fate_counts()
    assert reports[0]["stray_modules"] == reports[1]["stray_modules"] == []


def test_checkpoint_mesh_rejects_indivisible_bundle(world2):
    reports, _ = world2
    for report in reports:
        assert "multiples of the mesh" in report["refusal"]


def test_jax_checkpoint_resumes_in_the_port(jax_runs):
    """The JAX package's checkpoint after one bundle, resumed by the port
    (its stored bundle), gives the JAX package's uninterrupted tallies."""
    resumed = engine.simulate_checkpointed(_scene(), N_CROSS, jax_runs["partial"],
                                           seed=SEED_CROSS, lanes=LANES, **CPU)
    assert resumed.complete and resumed.bundle == B_CROSS
    _assert_within_parted(_ints(resumed), jax_runs["full"])


def test_port_checkpoint_resumes_in_the_jax_package(jax_runs):
    full = engine.simulate_checkpointed(_scene(), N_CROSS, None, bundle=B_CROSS,
                                        seed=SEED_CROSS, lanes=LANES, **CPU)
    _assert_within_parted(jax_runs["resumed_port"], _ints(full))


def test_scene_digest_is_the_same_in_both_packages():
    from pvtrace_tpu.engine.compiler import compile_scene as jax_compile

    assert engine.compile_scene(_scene()).content_digest == \
        jax_compile(_scene(pvtrace_tpu)).content_digest
