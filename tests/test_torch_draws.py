"""The trace kernel's draws (``kernels/csrc/tracer.cuh``), on the CPU
through the host build of the device code (``kernels/host.py``).

A refill draws each photon's key and the emission pairs the scene's lamps
read (``emit_pairs``, ``emit_draws``), not all three; a step draws its
four pairs (``pvt_draw``). ``h_draws`` runs both on emulated warps, as
``pvt_draws`` runs them on the card (``chip_smoke.py`` phase 27), and
``rng.warp_draws`` is their plain twin: every word drawn equals
threefry's (``rng.draw8``, ``rng.photon_keys``) bit for bit, and the
threefry calls each warp's refill makes, counted where the device code
makes them, are the key's and one for each pair drawn. The lamps' masks
(``light_pairs``, ``emit_pairs``) equal ``check.light_pairs``, and
``emit_one`` drawing them gives each lamp kind's photons the bits that
drawing every pair gives. The same inputs through the JAX package's
``_draw8``, ``_threefry2x32`` and ``_uniform32`` give the same words.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_host, mesh_lsc, mixed_scene  # noqa: E402
from test_torch_emit import LIGHTS, _build  # noqa: E402

B = 1 << 12


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


def _host_draws(h, seed_words, args):
    """``h_draws`` on ``check.draw_inputs``' `args`: (keys, emit, words, calls)."""
    base, dead, need, k0, k1, count, mask = args
    n = dead.numel()
    out = (torch.zeros((n, 2), dtype=torch.int64), torch.zeros((n, 6)), torch.zeros((n, 8)),
           torch.zeros(n // rng.WARP, dtype=torch.int32))
    h.h_draws(seed_words[0], seed_words[1], base.data_ptr(), dead.data_ptr(), need,
              k0.data_ptr(), k1.data_ptr(), count.data_ptr(), mask.data_ptr(), n,
              *(t.data_ptr() for t in out))
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("need", [7, 4, 3, 0], ids=["three-pairs", "slab-lamp", "two-pairs",
                                                    "none"])
@pytest.mark.parametrize("starts", [0, 1, 11, 32, None],
                         ids=["no-refill", "one", "eleven", "all", "random"])
def test_warp_draws_equal_threefry_on_host(host_lib, starts, need):
    """Per warp a refill of `starts` dead lanes (random where None: 0 to 32)
    with the emission pairs of `need`, and per lane random read masks: the
    host build's words and calls against the twin, and the twin's words
    against ``draw8`` and ``photon_keys``."""
    seed_words = rng.key_words(10 + need)
    args = check.draw_inputs(B, 100 * need + (starts or 0), "cpu", need, starts)
    got = _host_draws(host_lib, seed_words, args)
    ref = rng.warp_draws(seed_words, *args)
    for name, g, r in zip(("keys", "emit", "words", "calls"), got, ref):
        assert torch.equal(_bits(g), _bits(r)), name
    base, dead, _, k0, k1, count, mask = args
    u = torch.stack(rng.draw8(k0, k1, count.long(), torch.float32), 1)
    read = (mask.long()[:, None] >> torch.arange(8)) & 1 == 1
    assert torch.equal(_bits(got[2])[read], _bits(u)[read])
    assert bool((got[2][~read] == -1.0).all())
    d = dead.view(-1, rng.WARP).long()
    pids = base[:, None] + torch.cumsum(d, 1) - d
    pk0, pk1 = rng.photon_keys(seed_words, pids.reshape(-1))
    assert torch.equal(got[0][dead], torch.stack([pk0, pk1], 1)[dead])
    assert bool((got[0][~dead] == 0).all())
    drawn = torch.tensor([need >> (k // 2) & 1 == 1 for k in range(6)])
    assert bool((got[1][dead][:, drawn] >= 0).all())
    assert bool((got[1][:, ~drawn] == -1.0).all()) and bool((got[1][~dead] == -1.0).all())
    # The calls the host build counted: a refill makes the key call and one
    # call a pair; a warp without a dead lane none.
    np_ = bin(need).count("1")
    assert torch.equal(got[3].long(), torch.where(d.sum(1) > 0, 1 + np_, 0))


def _scene_struct(st):
    return kernels._scene(st, 1000, 0, float("inf"))


@pytest.mark.parametrize("make, need", [(lsc_slab, 4), (mesh_lsc, 4), (mixed_scene, 7),
                                        (lsc_slab_host, 0)],
                         ids=["slab", "mesh_lsc", "mixed", "host-lit"])
def test_emit_pairs_are_the_pairs_the_lamps_read(host_lib, make, need):
    """The scenes' emission masks as the device code finds them (the host
    build's ``light_pairs`` a lamp, ``emit_pairs`` the scene) against
    ``check.light_pairs``, the bound's copy of the rule: the bench slab's
    and the mesh LSC's lamp (one wavelength, from a point, in a cone) pair 2
    alone; the mixed scene's rectangle and disc lamps all three; the
    host-lit slab (its lamp's histogram spectrum left to the host) none. A
    refill of 32 lanes with that mask makes the key call and one a pair."""
    st = scene_tensors(compile_scene(make()), dtype=torch.float32)
    sc = ctypes.byref(_scene_struct(st))
    lamps = [host_lib.h_light_pairs(sc, li) for li in range(st["meta"]["n_lights"])]
    assert lamps == check.light_pairs(st)
    assert host_lib.h_emit_pairs(sc) == need
    args = check.draw_inputs(rng.WARP, 5, "cpu", need, rng.WARP)
    assert int(_host_draws(host_lib, rng.key_words(3), args)[3][0]) == 1 + bin(need).count("1")


def _host_emit(h, st, seed_words, need=None):
    """``h_emit`` (the scene's emission pairs) or, given `need`,
    ``h_emit_need`` of B photons from id 1000: the state's tensors."""
    sc, out = _scene_struct(st), kernels._empty_state(B, "cpu")
    ptrs = ctypes.byref(kernels._struct(kernels._State, out, kernels._STATE_PTRS))
    if need is None:
        h.h_emit(ctypes.byref(sc), seed_words[0], seed_words[1], 1000, B, ptrs)
    else:
        h.h_emit_need(ctypes.byref(sc), seed_words[0], seed_words[1], 1000, B, need, ptrs)
    return out


@pytest.mark.parametrize("name", sorted(LIGHTS) + ["mixed"])
def test_emit_draws_what_the_lamps_read_on_host(host_lib, name):
    """Each lamp kind of ``test_torch_emit``'s scenes, and the mixed scene's
    two, through the device code's ``emit_one``: drawing the scene's
    emission pairs (``emit_pairs``) gives every photon the bits that
    drawing all three gives, and the twin's state (``initial_state``):
    keys and integers equal, floats within 1e-5, as ``check.check_emit``
    holds ``pvt_emit`` on the card (the host's sinf and cosf are not
    torch's to the last bit, and a Henyey-Greenstein lamp's sqrt(1 - mu^2)
    near mu = -1 turns that into a few 1e-6)."""
    scene = mixed_scene() if name == "mixed" else _build(name)
    st = scene_tensors(compile_scene(scene), dtype=torch.float32)
    seed_words = rng.key_words(11)
    got = _host_emit(host_lib, st, seed_words)
    full = _host_emit(host_lib, st, seed_words, 7)
    for key, g in got.items():
        assert torch.equal(_bits(g), _bits(full[key])), key
    twin = tracer.initial_state(st, seed_words, 1000 + torch.arange(B))
    for key, ref in twin.items():
        if ref.dtype.is_floating_point:
            torch.testing.assert_close(got[key], ref, rtol=0, atol=1e-5, msg=key)
        else:
            assert torch.equal(got[key].long(), ref.long()), key


def test_draws_wrapper_runs_the_twin_on_cpu():
    """``kernels.draws`` on CPU tensors is the twin and launches nothing."""
    args = check.draw_inputs(2 * rng.WARP, 4, "cpu", 4)
    before = kernels.launches["pvt_draws"]
    got = kernels.draws(rng.key_words(2), *args)
    ref = rng.warp_draws(rng.key_words(2), *args)
    assert all(torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))
    assert kernels.launches["pvt_draws"] == before


def test_draws_equal_jax_on_host(host_lib):
    """The host build's words against the JAX package's streams on the same
    inputs: each step word ``_draw8``'s, each refilled lane's key
    ``_threefry2x32(seed, (pid, 0))`` and its emission words those of
    ``_device_emit_flat``'s counters (0, 16 + j)."""
    seed = 12
    args = check.draw_inputs(B, 77, "cpu", 7)
    got = _host_draws(host_lib, rng.key_words(seed), args)
    base, dead, _, k0, k1, count, mask = args
    j32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
    ref = jt._draw8(j32(k0), j32(k1), j32(count.long()), np.float32)
    read = (mask.long()[:, None] >> torch.arange(8)) & 1 == 1
    for k in range(8):
        want = torch.from_numpy(np.asarray(ref[k]).copy())
        assert torch.equal(_bits(got[2][:, k])[read[:, k]], _bits(want)[read[:, k]]), k
    s0, s1 = (int(w) for w in np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
    d = dead.view(-1, rng.WARP).long()
    pids = (base[:, None] + torch.cumsum(d, 1) - d).reshape(-1)[dead]
    full = lambda v: jnp.full(pids.shape, v, jnp.uint32)  # noqa: E731
    pk0, pk1 = jt._threefry2x32(full(s0), full(s1), j32(pids), full(0))
    for col, w in enumerate((pk0, pk1)):
        assert torch.equal(got[0][dead][:, col], torch.from_numpy(np.asarray(w).astype(np.int64)))
    for j in range(3):
        w0, w1 = jt._threefry2x32(pk0, pk1, full(0), full(16 + j))
        for col, w in ((2 * j, w0), (2 * j + 1, w1)):
            want = torch.from_numpy(np.asarray(jt._uniform32(w, np.float32)).copy())
            assert torch.equal(_bits(got[1][dead][:, col]), _bits(want)), (j, col)
