"""The port's CLI (``pvtrace_tpu_torch.cli``) against the JAX package's.

* ``parse`` builds each YAML scene from the port's classes, and it
  compiles to the same tables as the JAX package's parse of the same file
  (``tests/test_torch_host.py``'s comparison);
* ``schema.json`` and ``data/schema.sql`` are the JAX package's, byte for
  byte;
* ``--tracer python`` (the per-ray oracle on the global numpy stream)
  writes the same database row for row, floats bit for bit;
* the engine path: the port's ``simulate --device cpu`` (the eager twin,
  its ``simulate_stream`` wrapped here to pass ``dtype=np.float64``)
  against the JAX CLI, which traces float64 under the tests' x64, at
  N_ENGINE photons, seed 3: the databases equal photon by photon but for
  at most PARTED photons whose paths part by an ulp
  (``tests/test_torch_stream.py``'s allowance), every float of the others
  within FLOAT_RTOL of its column's largest value
  (``kernels/check.py::compare_databases``); ``count``, ``spectrum`` and
  ``time`` within the same allowance;
* the port's database is its own ``simulate_stream(...).histories()``,
  over several bundles;
* a budget of 0 writes the JAX package's empty database;
* a RuntimeError from the trace ends the command with it (no oracle run
  in its place), and without CUDA the default device raises;
* ``show`` writes the JAX CLI's HTML for the same seed;
* ``simulate --watch`` serves the run's messages to a viewer.

The JAX package is imported inside the fixtures and tests that use it,
so that the ``gpu`` tests run on the card with ``--noconftest``, where
there is no JAX: ``python -m pytest --noconftest tests/test_torch_cli.py
-m gpu``.
"""
import contextlib
import functools
import json
import sqlite3
from pathlib import Path

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import engine  # noqa: E402
from pvtrace_tpu_torch.cli import main as port_cli  # noqa: E402
from pvtrace_tpu_torch.kernels import check  # noqa: E402
from pvtrace_tpu_torch.studio.client import (  # noqa: E402
    captured,
    recorder_ints,
    tally_ints,
    watch_run,
)

cap_threads()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")


ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
SCENE = str(DATA / "lsc.yml")
YAMLS = {
    "tests/data/lsc.yml": DATA / "lsc.yml",
    "tests/data/lsc_scene_studio.yml": DATA / "lsc_scene_studio.yml",
    "examples/lsc.yml": ROOT / "examples" / "lsc.yml",
    "examples/hello_world.yml": ROOT / "examples" / "hello_world.yml",
}
N_ENGINE, SEED = 1 << 12, 3
N_PYTHON = 60
# Photons of the engine runs that may part between the packages by an
# ulp (each then differs in its events), as in test_torch_stream.py.
PARTED = 2
# The other photons' floats: |port - jax| over the column's largest
# |jax| (positions in cm, directions, nm, cm, s, normals), float64 both.
FLOAT_RTOL = 1e-9
EVENTS = ("entering", "escaping", "reflected", "nonradiative", "reacted", "killed")


def _simulate(app, db, n=N_ENGINE, *extra):
    return captured(app, ["simulate", SCENE, "-n", str(n), "--seed", str(SEED), "--database",
                          str(db), *extra])


@contextlib.contextmanager
def _float64_stream():
    """The port's simulate_stream in float64, as the JAX CLI runs under
    the tests' x64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "simulate_stream",
                   functools.partial(engine.simulate_stream, dtype=np.float64))
        yield


def _rows(path, table):
    with contextlib.closing(sqlite3.connect(path)) as connection:
        return connection.execute(f"SELECT * FROM {table} ORDER BY rowid").fetchall()


def _query_rows(app_module, db, prefix, event):
    args = app_module.build_parser().parse_args([prefix, str(db), "lsc", event])
    return app_module._query(args, prefix)


# -- the JAX package's runs, one compile ----------------------------------


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    from pvtrace_tpu.cli import main as jax_main

    return jax_main


@pytest.fixture(scope="module")
def engine_dbs(tmp_path_factory, jax_cli):
    """The engine path's databases: the JAX CLI's and the port's."""
    out = tmp_path_factory.mktemp("engine")
    rc, said = _simulate(jax_cli.app, out / "jax.sqlite3")
    assert rc == 0 and f"Wrote {N_ENGINE} ray histories" in said
    with _float64_stream():
        rc, said = _simulate(port_cli.app, out / "port.sqlite3", N_ENGINE, "--device", "cpu")
    assert rc == 0 and f"Wrote {N_ENGINE} ray histories" in said
    return out / "jax.sqlite3", out / "port.sqlite3"


# -- parse and the schema files ---------------------------------------------


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_parse_compiles_to_the_same_tables(name):
    from pvtrace_tpu.cli.parse import parse as jax_parse
    from pvtrace_tpu.engine.compiler import compile_scene as jax_compile
    from test_torch_host import SCENE_OBJECTS, _assert_same

    from pvtrace_tpu_torch.cli.parse import parse

    scene = parse(str(YAMLS[name]))
    assert type(scene).__module__ == "pvtrace_tpu_torch.scene.scene"
    ref = jax_compile(jax_parse(str(YAMLS[name])))
    got = engine.compile_scene(scene)
    assert sorted(vars(got)) == sorted(vars(ref))
    for key, value in vars(ref).items():
        if key not in SCENE_OBJECTS:
            _assert_same(value, getattr(got, key), key)
    assert [r.name for r in got.recorder_specs] == [r.name for r in ref.recorder_specs]


@pytest.mark.parametrize("path", ["cli/schema.json", "data/schema.sql"])
def test_schema_files_are_the_jax_packages(path):
    assert (ROOT / "pvtrace_tpu_torch" / path).read_bytes() == \
        (ROOT / "pvtrace_tpu" / path).read_bytes()


def test_schema_rejects_bad_spec(tmp_path):
    import jsonschema

    from pvtrace_tpu_torch.cli.parse import parse

    bad = tmp_path / "bad.yml"
    bad.write_text("version: '1.0'\nnodes:\n  world:\n    box: {}\n")
    with pytest.raises(jsonschema.ValidationError):
        parse(str(bad))


# -- the oracle path ---------------------------------------------------------


def test_python_tracer_databases_are_equal(tmp_path, jax_cli):
    """The per-ray oracle draws from the global numpy stream in both
    packages: the same rows, floats bit for bit."""
    for app, name in ((jax_cli.app, "jax"), (port_cli.app, "port")):
        rc, said = _simulate(app, tmp_path / f"{name}.sqlite3", N_PYTHON, "--tracer", "python")
        assert rc == 0 and f"Wrote {N_PYTHON} ray histories" in said
    for table in ("ray", "event"):
        got, ref = (_rows(tmp_path / f"{name}.sqlite3", table) for name in ("port", "jax"))
        assert len(ref) > N_PYTHON and got == ref, table


# -- the engine path ---------------------------------------------------------


def test_engine_database_matches_jax(engine_dbs):
    ref, got = engine_dbs
    report = check.compare_databases(got, ref)
    assert report["photons"] == N_ENGINE
    assert report["parted"] <= PARTED, report
    assert report["max_rel_err"] <= FLOAT_RTOL, report
    assert len(_rows(got, "event")) == len(_rows(got, "ray")) > 4 * N_ENGINE


@pytest.mark.parametrize("prefix", ["count", "spectrum", "time"])
@pytest.mark.parametrize("event", EVENTS)
def test_queries_match_jax(engine_dbs, jax_cli, prefix, event):
    """Each query of the lsc node on both databases, through the command
    (its printed output) and its rows: the count within PARTED, and each
    ray's value within FLOAT_RTOL of its own for all but PARTED rays."""
    ref_db, got_db = engine_dbs
    argv = [prefix, None, "lsc", event] + ([] if prefix == "count" else ["--output", "json"])
    said = {}
    for name, app, db in (("jax", jax_cli.app, ref_db), ("port", port_cli.app, got_db)):
        rc, said[name] = captured(app, [str(db) if a is None else a for a in argv])
        assert rc == 0
    if prefix == "count":
        assert abs(int(said["port"]) - int(said["jax"])) <= PARTED
        return
    got_values, ref_values = (json.loads(said[k]) for k in ("port", "jax"))
    assert abs(len(got_values) - len(ref_values)) <= 2 * PARTED
    got, ref = ({}, {})
    for rows, out in ((_query_rows(port_cli, got_db, prefix, event), got),
                      (_query_rows(jax_cli, ref_db, prefix, event), ref)):
        for throw_id, value in rows:
            out.setdefault(throw_id, []).append(value)
    if event in ("escaping", "entering", "nonradiative"):
        assert len(ref) > 100
    differ = [t for t in set(got) | set(ref)
              if t not in got or t not in ref or len(got[t]) != len(ref[t])
              or not np.allclose(sorted(got[t]), sorted(ref[t]), rtol=FLOAT_RTOL, atol=0)]
    assert len(differ) <= PARTED, differ


def test_database_is_its_own_stream(tmp_path):
    """The port's database over several bundles holds exactly
    ``write_history`` of its ``simulate_stream(...).histories()`` in
    order, throw_ids continuing across bundles."""
    n, bundle = 300, 128
    rc, said = _simulate(port_cli.app, tmp_path / "cli.sqlite3", n, "--bundle", str(bundle),
                         "--device", "cpu")
    assert rc == 0 and f"Wrote {n} ray histories" in said
    from pvtrace_tpu_torch.cli.parse import parse

    connection = port_cli.prepare_database(str(tmp_path / "stream.sqlite3"))
    cursor = connection.cursor()
    throw_id = 0
    stream = engine.simulate_stream(parse(SCENE), n, bundle=bundle, seed=SEED, record_every=1,
                                    device="cpu")
    for result, _ in stream:
        for history in result.histories():
            port_cli.write_history(cursor, throw_id, history)
            throw_id += 1
    connection.commit()
    connection.close()
    assert throw_id == n
    for table in ("ray", "event"):
        assert _rows(tmp_path / "cli.sqlite3", table) == _rows(tmp_path / "stream.sqlite3", table)


def test_budget_of_zero_is_the_jax_packages_empty_database(tmp_path, jax_cli):
    said = {}
    for name, app, extra in (("jax", jax_cli.app, ()), ("port", port_cli.app, ("--device", "cpu"))):
        rc, said[name] = _simulate(app, tmp_path / f"{name}.sqlite3", 0, *extra)
        assert rc == 0
    assert said["port"] == said["jax"].replace("jax.sqlite3", "port.sqlite3")
    assert "Wrote 0 ray histories" in said["port"]
    schema = {}
    for name in ("jax", "port"):
        with contextlib.closing(sqlite3.connect(tmp_path / f"{name}.sqlite3")) as connection:
            schema[name] = connection.execute(
                "SELECT type, name, sql FROM sqlite_master ORDER BY name").fetchall()
        for table in ("ray", "event"):
            assert _rows(tmp_path / f"{name}.sqlite3", table) == []
    assert schema["port"] == schema["jax"] and schema["port"]


# -- no fallback -------------------------------------------------------------


@pytest.fixture
def refuse_oracle(monkeypatch):
    """Fails a test in which the per-ray oracle traces a photon."""
    from pvtrace_tpu_torch.algorithm import photon_tracer

    def refuse(*args, **kwargs):
        raise AssertionError("the per-ray oracle ran")

    monkeypatch.setattr(photon_tracer, "step_forward", refuse)
    monkeypatch.setattr(photon_tracer, "follow", refuse)


def test_trace_error_ends_the_command(tmp_path, monkeypatch, refuse_oracle):
    """A RuntimeError from the trace (as a kernel that fails to build or
    launch raises) ends ``simulate`` with that error: only the compiler's
    UnsupportedSceneError falls back to the oracle."""
    from pvtrace_tpu_torch.engine import tracer

    def broken(*args, **kwargs):
        raise RuntimeError("the kernel did not launch")

    monkeypatch.setattr(tracer, "trace", broken)
    with pytest.raises(RuntimeError, match="the kernel did not launch"):
        _simulate(port_cli.app, tmp_path / "db.sqlite3", 100, "--device", "cpu")


def test_without_cuda_the_default_device_raises(tmp_path, refuse_oracle, no_card):
    eager = engine.tracer.eager_runs
    with pytest.raises(RuntimeError, match="CUDA"):
        _simulate(port_cli.app, tmp_path / "db.sqlite3", 100)
    assert engine.tracer.eager_runs == eager
    assert not (tmp_path / "db.sqlite3").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.app(["studio", SCENE, "--port", "0", "--no-browser"])


# -- show and --watch --------------------------------------------------------


def test_show_writes_the_jax_clis_html(tmp_path, jax_cli):
    html = {}
    for name, app in (("jax", jax_cli.app), ("port", port_cli.app)):
        out = tmp_path / f"{name}.html"
        rc, said = captured(app, ["show", SCENE, "--output", str(out), "--rays", "3", "--seed",
                                  "1"])
        assert rc == 0 and said.strip() == str(out)
        html[name] = out.read_text()
    assert "canvas" in html["port"]
    assert html["port"] == html["jax"]


def test_watch_serves_the_runs_tallies(tmp_path):
    """``simulate --watch``: the viewer sees started, a bundle a bundle,
    done; the last bundle's recorders are one ``simulate``'s of the seed."""
    n, bundle = 400, 150
    rc, _, messages = watch_run(port_cli.app, [
        "simulate", SCENE, "-n", str(n), "--seed", str(SEED), "--database",
        str(tmp_path / "db.sqlite3"), "--bundle", str(bundle), "--watch", "--no-browser",
        "--port", "0", "--device", "cpu"])
    assert rc == 0
    assert [m["type"] for m in messages] == ["started"] + ["bundle"] * 3 + ["done"]
    last = [m for m in messages if m["type"] == "bundle"][-1]
    assert last["traced"] == n and last["paths"] is not None
    from pvtrace_tpu_torch.cli.parse import parse

    scene = parse(SCENE)
    one = engine.simulate(scene, n, seed=SEED, record_every=0, device="cpu")
    want = tally_ints(one.compiled, one.data["rec_distinct"], one.data["rec_crossings"],
                       one.data["rec_bins"])
    assert recorder_ints(last["recorders"]) == want
    assert sum(r[0] for r in want.values()) > 0


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_cli_on_the_card_matches_the_cpu_twin(tmp_path, card):
    """``simulate`` on the card (float32: pvt_trace with the log and
    pvt_log_pack) against ``--device cpu`` (float32) at 2^12: the
    databases photon by photon, at most LOG_DIVERGED of the photons
    parted, the others' floats within LOG_RTOL of their column's scale
    (``check_log``'s allowance)."""
    from pvtrace_tpu_torch import kernels

    kernels.reset()
    rc, _ = _simulate(port_cli.app, tmp_path / "card.sqlite3", N_ENGINE)
    assert rc == 0
    assert kernels.launches["pvt_trace_log"] == 1 and kernels.launches["pvt_log_pack"] == 1
    rc, _ = _simulate(port_cli.app, tmp_path / "cpu.sqlite3", N_ENGINE, "--device", "cpu")
    assert rc == 0
    report = check.compare_databases(tmp_path / "card.sqlite3", tmp_path / "cpu.sqlite3")
    assert report["parted"] <= check.LOG_DIVERGED * N_ENGINE, report
    assert report["max_rel_err"] <= check.LOG_RTOL, report
