"""K5a: the port's piecewise-Chebyshev spectra against the JAX package.

* the eager twin's fits (``chebyshev.eval_fits`` on the flat tensors of
  ``tables.scene_tensors``) against the JAX ``_eval_fit`` on the
  compiler's fit descriptors, every fit of the bench and mixed scenes;
* the device code's ``cheb_eval`` (``tracer.cuh``, built for the host)
  against the twin, and its segment search against the twin's masks at
  every breakpoint, its float32 neighbours, the ends and NaN;
* ``scene_tensors`` refuses a piecewise fit that does not partition
  [-1, 1], which the search relies on;
* ``simulate`` of the mixed scene at both packages' defaults, which
  take K5a for it (no ``PVTRACE_TPU_NO_CHEB``; the test gets an empty
  JAX tracer cache, whose key ignores the variable). The bench slab
  runs at the defaults, float64 and float32, in ``test_torch_tally.py``.
"""
import ctypes

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene as jax_compile_scene  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import chebyshev, compile_scene, simulate, tables  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab, mixed_scene  # noqa: E402

cap_threads()
SCENES = {"bench": lsc_slab, "mixed": mixed_scene}
# |port - JAX| over the fit's largest |value| on the t grid, per dtype:
# the same Clenshaw operations in the same order; exp and the rounding
# of the affine map may differ in the last bit.
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
# The device code (float32, host build without FMA contraction) against
# the float32 twin: exp may differ in the last bit.
HOST_RTOL = 1e-6


@pytest.fixture
def defaults(monkeypatch):
    """Both packages at their defaults: K5a wherever the fits exist."""
    monkeypatch.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    monkeypatch.setattr(jax_api, "_TRACER_CACHE", {})


def _jax_fits(compiled):
    """The JAX compiler's fit descriptors in the port's flat order:
    components, non-cumulative slot fits node by node, emission ICDFs,
    lamp ICDFs (``tables._cheb_records``)."""
    slot_fits = [
        fit for _, fits in sorted(compiled.cheb_spec.items()) for fit in fits
        if fit[0] != "cum"
    ]
    return [*compiled.cheb_comp, *slot_fits, *compiled.cheb_icdf,
            *compiled.cheb_light_icdf]


def _t_grid(compiled, n=4096):
    """`n` values of t on [-1, 1]: evenly spaced, plus every segment edge
    of every piecewise fit, where the masks switch."""
    edges = [
        edge for fit in _jax_fits(compiled) if fit[0] == "pw"
        for a, b, _, _ in fit[1] for edge in (a, b)
    ]
    t = np.concatenate([np.unique(edges), np.linspace(-1.0, 1.0, n)])[:n]
    return np.sort(t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_eval_fits_match_jax(name, dtype, defaults):
    jax_compiled = jax_compile_scene(SCENES[name](pvtrace_tpu))
    st = tables.scene_tensors(
        compile_scene(SCENES[name]()),
        dtype=torch.float64 if dtype == np.float64 else torch.float32,
    )
    fits = _jax_fits(jax_compiled)
    assert len(fits) == st["meta"]["cheb_n_fits"]
    assert any(fit[0] == "pw" for fit in fits)
    t = _t_grid(jax_compiled).astype(dtype)
    got = kernels.cheb(st, torch.from_numpy(t)).numpy()
    with jax.enable_x64(dtype == np.float64):
        for f, fit in enumerate(fits):
            ref = np.asarray(jt._eval_fit(jnp.asarray(t), fit))
            assert ref.dtype == dtype
            scale = max(np.abs(ref).max(), 1e-30)
            err = np.abs(got[f] - ref).max() / scale
            assert err <= RTOL[dtype], (f, fit[0], err)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_device_cheb_eval_matches_twin_on_host(host_lib, name):
    st = tables.scene_tensors(compile_scene(SCENES[name]()), dtype=torch.float32)
    F = st["meta"]["cheb_n_fits"]
    t = torch.linspace(-1.0, 1.0, 4096, dtype=torch.float32)
    got = torch.empty((F, t.shape[0]), dtype=torch.float32)
    sc = kernels._scene(st, 1000, 0, float("inf"))
    host_lib.h_cheb(ctypes.byref(sc), F, t.data_ptr(), t.shape[0], got.data_ptr())
    fits = torch.arange(F).repeat_interleave(t.shape[0])
    ref = chebyshev.eval_fits(st, fits, t.repeat(F)).reshape(F, -1)
    scale = ref.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((got - ref).abs() / scale).max()) <= HOST_RTOL


@pytest.mark.parametrize("name", sorted(SCENES))
def test_device_cheb_segment_matches_twin_on_host(host_lib, name):
    """The search over the breakpoints picks the twin's segment (the
    reference's masks) exactly at every breakpoint, its float32
    neighbours on both sides, -1, 1 and NaN, and the values agree."""
    st = tables.scene_tensors(compile_scene(SCENES[name]()), dtype=torch.float32)
    F = st["meta"]["cheb_n_fits"]
    t = check.cheb_points(st)
    n = t.shape[0]
    assert bool(t.isnan().any()) and bool(torch.isin(st["cheb_seg_f"][:, tables.SF_B], t).all())
    got = torch.empty((F, n), dtype=torch.float32)
    seg = torch.empty((F, n), dtype=torch.int32)
    sc = kernels._scene(st, 1000, 0, float("inf"))
    host_lib.h_cheb_seg(ctypes.byref(sc), F, t.data_ptr(), n, got.data_ptr(), seg.data_ptr())
    fits = torch.arange(F).repeat_interleave(n)
    assert torch.equal(seg.long(), chebyshev._segment(st, fits, t.repeat(F)).reshape(F, -1))
    ref = chebyshev.eval_fits(st, fits, t.repeat(F)).reshape(F, -1)
    nan = ref.isnan()
    assert torch.equal(got.isnan(), nan)
    scale = ref.masked_fill(nan, 0.0).abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((got - ref).abs().masked_fill(nan, 0.0) / scale).max()) <= HOST_RTOL


@pytest.mark.parametrize("fault", ["gap", "overlap"])
def test_scene_tensors_refuses_a_fit_that_is_no_partition(fault):
    """A piecewise fit whose second segment starts after (a gap) or before
    (an overlap) the first one's end is refused, naming the fit."""
    compiled = compile_scene(lsc_slab())
    kind, segs, off = compiled.cheb_icdf[0]
    assert kind == "pw"
    a, b, skind, coef = segs[1]
    shift = 1e-3 if fault == "gap" else -1e-3
    compiled.cheb_icdf[0] = (kind, (segs[0], (a + shift, b, skind, coef), *segs[2:]), off)
    with pytest.raises(ValueError, match="emission ICDF 0"):
        tables.scene_tensors(compiled)


def test_scene_tensors_refuses_cumulative_slots_that_are_not_prefixes():
    """The kernel forms a node's cumulative slots from the partial sums of
    its last one; a slot that lists other components is refused."""
    compiled = compile_scene(mixed_scene())
    node, fits = next((n, f) for n, f in compiled.cheb_spec.items() if len(f[2][1]) == 3)
    compiled.cheb_spec[node] = [fits[0], ("cum", fits[2][1][1:2], 0.0), *fits[2:]]
    with pytest.raises(ValueError, match=f"node {node}"):
        tables.scene_tensors(compiled)


def test_simulate_at_defaults_float64_matches_jax(defaults):
    """The mixed scene, whose two component nodes take the per-container
    slot fits (the bench slab's one node takes the single-node rule; it
    runs at the defaults in ``test_torch_tally.py``, with recorders)."""
    n, lanes = 2 ** 11, 2 ** 9
    compiled = compile_scene(mixed_scene())
    st = tables.scene_tensors(compiled, dtype=torch.float64)
    assert st["meta"]["cheb_spec"] and st["meta"]["cheb_icdf"]
    ref = jax_engine.simulate(mixed_scene(pvtrace_tpu), n, seed=5, record_every=0,
                              dtype=np.float64, lanes=lanes, emit_method="redshift")
    got = simulate(mixed_scene(), n, seed=5, record_every=0, dtype=np.float64, lanes=lanes,
                   device="cpu", compiled=compiled, emit_method="redshift")
    ref, got = (np.asarray(r.data["fates"], dtype=np.int64) for r in (ref, got))
    assert ref.sum() == n and got.sum() == n
    assert got[7] > 0 and got[4] > 0 and got[8] > 0
    assert np.abs(got - ref).max() <= 4, (got.tolist(), ref.tolist())
