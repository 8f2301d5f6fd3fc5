"""Random nested and touching scenes: the port's twin against the JAX
package's engine.

Each package traces ``random_scene(seed, ns)`` built from its own classes
under the scene's emit method and caps, on the exact table lerp (K5b,
``PVTRACE_TPU_NO_CHEB``, as ``test_torch_simulate.py``'s
``jax_exact_lerp``): in float64 the fates agree photon for photon up to
``ULP_PHOTONS``, in float32 within z < 5 (the JAX side with 64-bit mode
off, ROADMAP queue 3). A JAX compile takes 5-30 s a scene, so tier-1 runs
the three CPU seeds with the fewest nodes and the other seventeen are
``slow``. The JAX package's float32 engine repeats a crossing after a long
free path as the port's does (``kernels.crafted.repeats``).
"""
import numpy as np
import pytest

from _random_cases import CPU_SEEDS, ULP_PHOTONS
from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu_torch.engine import simulate  # noqa: E402
from pvtrace_tpu_torch.kernels import crafted  # noqa: E402
from pvtrace_tpu_torch.scenes import random_scene  # noqa: E402

cap_threads()
N = 1 << 12
SMALL = tuple(sorted(CPU_SEEDS, key=lambda s: (random_scene(s).features["nodes"], s))[:3])
FATES = {4: "NONRADIATIVE", 7: "EXIT", 8: "REACT", 9: "KILL", 10: "NO_HIT"}


@pytest.fixture
def jax_exact_lerp(monkeypatch):
    monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    monkeypatch.setattr(jax_api, "_TRACER_CACHE", {})


def _fates(seed, dtype, ns=None):
    built = random_scene(seed, ns)
    if ns is None:
        result = simulate(built.scene, N, seed=seed, record_every=0, dtype=dtype, device="cpu",
                          lanes=1 << 10, **built.options)
    else:
        result = jax_engine.simulate(built.scene, N, seed=seed, record_every=0, dtype=dtype,
                                     **built.options)
    fates = np.asarray(result.data["fates"], dtype=np.int64)
    assert fates.sum() == N
    return fates


def _float64_parity(seed):
    ref, got = _fates(seed, np.float64, pvtrace_tpu), _fates(seed, np.float64)
    assert np.abs(got - ref).max() <= ULP_PHOTONS, (got.tolist(), ref.tolist())


@pytest.mark.parametrize("seed", SMALL)
def test_twin_matches_jax_float64_on_random_scene(seed, jax_exact_lerp):
    _float64_parity(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [s for s in CPU_SEEDS if s not in SMALL])
def test_twin_matches_jax_float64_on_random_scene_slow(seed, jax_exact_lerp):
    _float64_parity(seed)


@pytest.mark.parametrize("seed", SMALL)
def test_twin_agrees_with_jax_float32_on_random_scene(seed, jax_exact_lerp):
    with jax.enable_x64(False):
        ref = _fates(seed, np.float32, pvtrace_tpu)
    got = _fates(seed, np.float32)
    for slot, name in FATES.items():
        pooled = (ref[slot] + got[slot]) / (2.0 * N)
        if pooled == 0.0:
            continue
        z = abs(ref[slot] - got[slot]) / N / np.sqrt(pooled * (1 - pooled) * 2.0 / N)
        assert z < 5, (name, got.tolist(), ref.tolist())


def test_jax_float32_engine_repeats_crossings_after_long_free_paths():
    """The JAX package's float32 ``trace_bundle`` on seed 17's crafted
    rays (index-matched, float32) crosses s1 twice at one point on some
    rays that reach it after a free path of tens of centimetres, as the
    port's float32 engine does on others: the reference fault the crafted
    comparison leaves out (``kernels.crafted.repeats``)."""
    from pvtrace_tpu.engine import compile_scene as jax_compile
    from pvtrace_tpu.engine import tracer as jax_tracer
    from pvtrace_tpu.engine.api import _get_tables

    built = random_scene(17, pvtrace_tpu, matched=True)
    compiled = jax_compile(built.scene)
    bundle = crafted.crafted_bundle(built, torch.float32).numpy()
    cfg = jax_tracer.make_config(compiled, n_rays=bundle.shape[1], dtype=np.float32,
                                 record_every=1)
    tables = _get_tables(compiled, np.float32)
    _, log, counts, _ = jax.jit(lambda: jax_tracer.trace_bundle(
        compiled, cfg, tables, bundle[0:3].T, bundle[3:6].T, bundle[6],
        jax.random.PRNGKey(17)))()
    log = tuple(torch.from_numpy(np.array(a)) for a in (log["ints"], log["floats"], counts))
    found = [j for j in range(bundle.shape[1])
             if crafted.repeats(crafted.engine_records(log, j, compiled.node_names), 1e-3)]
    assert found
    for j in found:
        got = crafted.engine_records(log, j, compiled.node_names)
        assert got[1][1:4] == got[2][1:4] and got[1][2] == "world"
        assert np.linalg.norm(np.subtract(got[1][4], built.rays[0][j])) > 0.5 * built.scale
