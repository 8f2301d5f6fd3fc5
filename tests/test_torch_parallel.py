"""K14: the port's sharded runs against its single-process runs and the
JAX package's 8-device mesh.

``pvtrace_tpu_torch.parallel`` splits the photon axis over a
``torch.distributed`` process group, one process per device, and
all-reduces every tally. Here a world of two rank processes on gloo, on
the CPU (this file run as a script, once per rank, from a module
fixture that reads their JSON), is held to a world of one (this
process, no group) and to the JAX package's ``shard_simulate`` over the
8-device CPU mesh of ``tests/conftest.py``, on ``test_parallel.py``'s
LSC scene at 8000 photons in float64: integer tallies bit for bit, float
sums within rtol 1e-12, atol 1e-9 (``test_parallel.py:176-181``);
``fate_gradients(mesh=)`` fractions equal and gradients within rtol
1e-10, atol 1e-12; ``make_training_step`` in float32 on an axis-aligned
slab (K15's parity rule) within 1e-6 relative of JAX's, and a world of
two within float32 rounding of a world of one. The JAX runs are four
compiles, shared through a module fixture.

Run as a script (``python tests/test_torch_parallel.py RANK WORLD PORT
OUT``), the file is one rank: it imports torch and the port only, joins
the gloo world at ``tcp://localhost:PORT``, runs every case and writes
its results to OUT.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

N = 8000
N_HOST = 4000
LANES = 256
# The twin's wavefront for the score runs: the tallies do not depend on it
# (photon streams are per photon), and 2048 lanes take a quarter of the
# time of 256 with pathwise channels on the CPU.
SCORE_LANES = 2048
P_TRAIN = 4096
TRAIN_STEPS = 2
LOG_C0 = 0.3
SUMS = dict(rtol=1e-12, atol=1e-9)
GRADS = dict(rtol=1e-10, atol=1e-12)
INTS = ("fates", "rec_distinct", "rec_crossings", "rec_bins")
FLOATS = ("rec_sums", "fate_scores", "rec_scores")


def lsc_scene(ns=None):
    """``tests/test_parallel.py::lsc_scene``: a 5x5x1 dye slab with an
    escaping-light recorder (a 40-bin wavelength histogram) under a 555 nm
    lamp."""
    from pvtrace_tpu_torch.scenes import api

    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=12.0, material=p.Material(refractive_index=1.0)))
    lsc = p.Node(name="lsc", parent=world, geometry=p.Box((5.0, 5.0, 1.0), material=p.Material(
        refractive_index=1.5, components=[
            p.Luminophore(coefficient=np.column_stack((x, p.lumogen_f_red_305.absorption(x) * 8.0)),
                          emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                          quantum_yield=0.9),
            p.Absorber(0.2),
        ])))
    lsc.recorders = [p.Recorder("escape", event="escaping",
                                histograms=[p.Histogram("wavelength", 400, 800, 40)])]
    light = p.Node(name="light", parent=world,
                   light=p.Light(wavelength=p.ConstantWavelengthMask(555.0)))
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def custom_scene(ns=None):
    """``tests/test_parallel.py``'s ball under a lamp whose position is a
    bare callable: host emission."""
    from pvtrace_tpu_torch.scenes import api

    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=12.0, material=p.Material(refractive_index=1.0)))
    p.Node(name="ball", geometry=p.Sphere(radius=1.0, material=p.Material(refractive_index=1.5)),
           parent=world)
    light = p.Node(name="light", parent=world, light=p.Light(
        wavelength=p.ConstantWavelengthMask(555.0), position=lambda: (0.05, 0.0, 0.0)))
    light.translate((0.0, 0.0, -3.0))
    return p.Scene(world)


def train_photons():
    """Photons from below the absorber slab, mostly upward, float32."""
    rng = np.random.default_rng(3)
    pos = np.column_stack([rng.uniform(-0.9, 0.9, P_TRAIN), rng.uniform(-0.9, 0.9, P_TRAIN),
                           np.full(P_TRAIN, -4.0)]).astype(np.float32)
    d = rng.normal(size=(P_TRAIN, 3))
    d[:, 2] = np.abs(d[:, 2]) * 8.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return pos, d, np.full(P_TRAIN, 555.0, np.float32)


def _plain(data):
    """A shard_simulate result as JSON-ready lists."""
    return {k: (np.asarray(v).tolist() if k != "steps" else int(v)) for k, v in data.items()}


def _refused(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


def port_runs(mesh):
    """Every case of the port on `mesh` (this process's rank), JSON-ready."""
    import torch

    from pvtrace_tpu_torch.diff import transport
    from pvtrace_tpu_torch.engine import compile_scene
    from pvtrace_tpu_torch.parallel import shard, shard_simulate
    from pvtrace_tpu_torch.scenes import absorber_slab

    torch.set_num_threads(1)
    scene = lsc_scene()
    compiled = compile_scene(scene)
    f64 = dict(dtype=np.float64, device="cpu", compiled=compiled)
    out = {"rank": mesh.rank, "size": mesh.size}
    out["device"] = _plain(shard_simulate(scene, N, mesh, seed=9, lanes=LANES, **f64))

    seen = {}

    def spy(*args, **kwargs):
        seen["data"] = shard_simulate(*args, **kwargs)
        return seen["data"]

    shard.shard_simulate, keep = spy, shard.shard_simulate
    try:
        fractions, grads = transport.fate_gradients(
            scene, N, seed=5, wrt="all", pathwise=[("n", "lsc")], mesh=mesh, lanes=SCORE_LANES,
            dtype=np.float64, device="cpu")
    finally:
        shard.shard_simulate = keep
    out["score"] = _plain(seen["data"])
    out["grad"] = {"fractions": {e.name: float(v) for e, v in fractions.items()},
                   "gradients": {e.name: np.asarray(g).tolist() for e, g in grads.items()}}

    step = transport.make_training_step(compile_scene(absorber_slab()), mesh)
    pos, d, wav = (torch.from_numpy(a) for a in train_photons())
    rows = slice(mesh.rank * P_TRAIN // mesh.size, (mesh.rank + 1) * P_TRAIN // mesh.size)
    params = {"log_concentration": torch.tensor(LOG_C0, dtype=torch.float32)}
    out["train"] = []
    for _ in range(TRAIN_STEPS):
        params, loss = step(params, pos[rows], d[rows], wav[rows])
        out["train"].append((float(loss), float(params["log_concentration"])))

    out["refusals"] = {
        "host-emission": _refused(lambda: shard_simulate(custom_scene(), 800, mesh, seed=1,
                                                         device="cpu")),
        "record-every": _refused(lambda: shard_simulate(scene, 800, mesh, seed=1,
                                                        record_every=1, device="cpu")),
        "budget": _refused(lambda: shard_simulate(scene, 800, mesh, seed=1, device="cpu",
                                                  index_offset=2 ** 32 - 400)),
    }
    if mesh.size > 1:
        out["refusals"]["indivisible"] = _refused(
            lambda: transport.fate_gradients(scene, N + 1, seed=1, mesh=mesh, device="cpu"))
    return out


def _rank_main(rank, world, port, path):
    """One rank of a gloo world on the CPU: every case, to JSON at `path`."""
    from pvtrace_tpu_torch.parallel import (
        init_distributed,
        is_multiprocess,
        make_photon_mesh,
        shutdown_distributed,
    )

    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                     rank=rank, device="cpu")
    assert is_multiprocess() == (world > 1)
    out = port_runs(make_photon_mesh(device="cpu"))
    stray = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pvtrace_tpu"))
    out["stray_modules"] = stray
    shutdown_distributed()
    with open(path, "w") as fh:
        json.dump(out, fh)


# -- the tests ----------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The two ranks' results of a gloo world of two."""
    tmp = tmp_path_factory.mktemp("world2")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    paths = [str(tmp / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
                               paths[r]], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text.decode(errors="replace")[-3000:]
    results = []
    for path in paths:
        with open(path) as fh:
            results.append(json.load(fh))
    return results


@pytest.fixture(scope="module")
def world1():
    """The port's results in this process, a mesh of one without a group."""
    from pvtrace_tpu_torch.parallel import make_photon_mesh

    return json.loads(json.dumps(port_runs(make_photon_mesh(device="cpu"))))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's results over its 8-device CPU mesh: the device-
    emitted run, the score run with fate_gradients on it (one compile),
    the host-emitted scene, and make_training_step."""
    import jax
    import jax.numpy as jnp

    import pvtrace_tpu
    from pvtrace_tpu.diff import transport as jax_transport
    from pvtrace_tpu.engine import api as jax_api
    from pvtrace_tpu.engine.compiler import compile_scene as jax_compile
    from pvtrace_tpu.parallel.shard import make_photon_mesh, shard_simulate
    from pvtrace_tpu_torch.scenes import absorber_slab

    mesh = make_photon_mesh()
    assert mesh.devices.size == 8
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        scene = lsc_scene(pvtrace_tpu)
        compiled = jax_compile(scene)
        kw = dict(dtype=np.float64, compiled=compiled, lanes=LANES)
        out["device"] = _plain(shard_simulate(scene, N, mesh, seed=9, **kw))
        pw = jax_transport.resolve_pathwise_params(compiled, [("n", "lsc")])
        out["score"] = _plain(shard_simulate(scene, N, mesh, seed=5, score=True, pathwise=pw,
                                             **kw))
        fractions, grads = jax_transport.fate_gradients(
            scene, N, seed=5, wrt="all", pathwise=[("n", "lsc")], mesh=mesh, **kw)
        out["grad"] = {"fractions": {e.name: float(v) for e, v in fractions.items()},
                       "gradients": {e.name: np.asarray(g).tolist() for e, g in grads.items()}}
        np.random.seed(21)
        out["host"] = _plain(shard_simulate(custom_scene(pvtrace_tpu), N_HOST, mesh, seed=6,
                                            dtype=np.float64))
        step = jax_transport.make_training_step(jax_compile(absorber_slab(ns=pvtrace_tpu)), mesh)
        pos, d, wav = (jnp.asarray(a) for a in train_photons())
        params = {"log_concentration": jnp.asarray(np.float32(LOG_C0))}
        out["train"] = []
        for _ in range(TRAIN_STEPS):
            params, loss = step(params, pos, d, wav, jax.random.PRNGKey(0))
            assert np.asarray(loss).dtype == np.float32
            out["train"].append((float(loss), float(params["log_concentration"])))
    return out


def _runs(world, world1, world2):
    return {"world-1": [world1], "world-2": world2}[world]


def _assert_tallies(got, ref, ints=INTS, floats=FLOATS):
    for key in ints:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)
    for key in floats:
        if key in ref:
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), **SUMS,
                                       err_msg=key)


@pytest.mark.parametrize("world", ["world-1", "world-2"])
def test_device_emission_matches_jax_mesh(world, world1, world2, jax_runs):
    """shard_simulate with device emission and 256 lanes: the integer
    tallies bit for bit, rec_sums within rtol 1e-12."""
    for run in _runs(world, world1, world2):
        got, ref = run["device"], jax_runs["device"]
        assert sum(got["fates"]) == N and got["fates"][7] > 0 and min(got["rec_distinct"]) > 0
        _assert_tallies(got, ref)


@pytest.mark.parametrize("world", ["world-1", "world-2"])
def test_score_tallies_match_jax_mesh(world, world1, world2, jax_runs):
    """score=True with the slab's index as a pathwise channel: every
    accumulator of the sharded run, fate_scores and rec_scores included."""
    for run in _runs(world, world1, world2):
        got, ref = run["score"], jax_runs["score"]
        assert set(got) == set(ref)
        assert np.abs(np.asarray(got["fate_scores"])).max() > 0
        _assert_tallies(got, ref)


def test_world_of_two_equals_world_of_one(world1, world2):
    """Both ranks hold the same reduced tallies, and those of one process:
    integers bit for bit, float sums to summation order."""
    assert [r["rank"] for r in world2] == [0, 1] and world2[0]["size"] == 2
    for case in ("device", "score"):
        assert world2[0][case] == world2[1][case], case
        _assert_tallies(world2[0][case], world1[case])
    assert world2[0]["grad"] == world2[1]["grad"]
    assert world2[0]["train"] == world2[1]["train"]


@pytest.mark.parametrize("world", ["world-1", "world-2"])
def test_fate_gradients_mesh_matches_jax(world, world1, world2, jax_runs):
    """fate_gradients(mesh=...): fractions equal, gradients within rtol
    1e-10, atol 1e-12, of the JAX package's and of the world of one."""
    for run in _runs(world, world1, world2):
        for ref in (jax_runs["grad"], world1["grad"]):
            assert run["grad"]["fractions"] == ref["fractions"]
            for event, g in ref["gradients"].items():
                np.testing.assert_allclose(run["grad"]["gradients"][event], g, **GRADS,
                                           err_msg=event)
        assert any(abs(g[-1]) > 0 for g in run["grad"]["gradients"].values())


def test_host_emitted_scene_world_of_one_matches_jax(jax_runs):
    """A host-emitted scene on a mesh of one: the bundle from the same
    np.random state, fates and tallies equal to the JAX package's sharded
    run and to the port's simulate."""
    from pvtrace_tpu_torch.engine import simulate
    from pvtrace_tpu_torch.parallel import make_photon_mesh, shard_simulate

    mesh = make_photon_mesh(device="cpu")
    np.random.seed(21)
    got = _plain(shard_simulate(custom_scene(), N_HOST, mesh, seed=6, dtype=np.float64,
                                device="cpu"))
    np.random.seed(21)
    single = simulate(custom_scene(), N_HOST, seed=6, record_every=0, dtype=np.float64,
                      device="cpu").data
    assert sum(got["fates"]) == N_HOST
    _assert_tallies(got, jax_runs["host"])
    assert got["fates"] == single["fates"].tolist()


@pytest.mark.parametrize("world", ["world-1", "world-2"])
def test_training_step_matches_jax(world, world1, world2, jax_runs):
    """make_training_step in float32 on the absorber slab: each step's loss
    and new log_concentration within 1e-6 relative of the JAX package's;
    a world of two within float32 rounding of the two partial sums of a
    world of one."""
    for run in _runs(world, world1, world2):
        for (loss, lc), (ref_loss, ref_lc) in zip(run["train"], jax_runs["train"]):
            assert loss == pytest.approx(ref_loss, rel=1e-6)
            assert lc == pytest.approx(ref_lc, rel=1e-6)
        before = LOG_C0
        for (loss, lc), (one_loss, one_lc) in zip(run["train"], world1["train"]):
            # A float32 sum of the P weights (and of the gradient's terms)
            # taken in two halves differs from one taken whole by up to about
            # log2(P) roundings of the sum: the mean (<= 1) by `rel` at most,
            # the loss (mean - target)^2 by 2 |mean - target| rel, the step
            # lr * grad by a few rel of itself, and lc rounds once more.
            rel = np.log2(P_TRAIN) * 2.0 ** -24
            assert abs(loss - one_loss) <= 2 * np.sqrt(one_loss) * rel
            assert abs(lc - one_lc) <= 4 * rel * abs(one_lc - before) + 2.0 ** -23 * abs(one_lc)
            before = one_lc
    assert run["train"][1][1] != LOG_C0


@pytest.mark.parametrize("case, match", [
    ("host-emission", "across processes"), ("record-every", "record_every=0"),
    ("budget", "photon ids"), ("indivisible", "multiple of the mesh"),
])
def test_refusals_across_processes(world2, case, match):
    """The JAX package's rules carry over to a world of two, each refused
    with a ValueError before any work."""
    for run in world2:
        message = run["refusals"][case]
        assert message is not None and match in message, message


def test_world_of_one_refuses_only_what_one_process_cannot_run(world1):
    """On one process the host-emitted scene runs; the tallies-only and
    budget rules still hold."""
    refusals = world1["refusals"]
    assert refusals["host-emission"] is None
    assert "record_every=0" in refusals["record-every"] and "photon ids" in refusals["budget"]


def test_rank_processes_import_neither_jax_nor_the_jax_package(world2):
    assert world2[0]["stray_modules"] == world2[1]["stray_modules"] == []


def test_init_distributed_without_a_world_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from pvtrace_tpu_torch.parallel import init_distributed, is_multiprocess, make_photon_mesh

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    init_distributed(device="cpu")
    assert not dist.is_initialized() and not is_multiprocess()
    mesh = make_photon_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
