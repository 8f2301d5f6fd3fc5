"""Random nested and touching scenes: the eager twin against the oracle.

``scenes.random_scene(seed)`` builds a seeded scene of disjoint, nested
(up to three levels) and touching nodes with random rigid transforms,
materials, overrides, recorders, lights and run options. The seeds are
fixed here: 0-19 run on the CPU, 20-31 only on the card
(``chip_smoke.py`` phase 38). On every CPU seed the port's ``simulate``
(the eager twin, float64) and the port's copy of the oracle
(``algorithm/photon_tracer.py``) trace the scene under its own
``emit_method`` and caps, and every fate fraction agrees within z < 5
(as the JAX package's ``tests/test_mesh_engine.py`` holds its engine to
the oracle); the coverage test shows what the fixed seeds hold. No JAX
here.
"""
import inspect
import time

import numpy as np
import pytest

from _random_cases import CARD_SEEDS, CPU_SEEDS
from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch.algorithm import photon_tracer  # noqa: E402
from pvtrace_tpu_torch.engine import simulate  # noqa: E402
from pvtrace_tpu_torch.scenes import (  # noqa: E402
    RANDOM_COMPONENTS,
    RANDOM_EMIT,
    RANDOM_MASKS,
    RANDOM_MESHES,
    RANDOM_SOLIDS,
    _random_plan,
    random_scene,
)

cap_threads()
FATES = {4: "NONRADIATIVE", 7: "EXIT", 8: "REACT", 9: "KILL", 10: "NO_HIT"}
N_TWIN = 1 << 12
N_ORACLE = 400


def oracle_fates(built, n, np_seed):
    """Fate counts [11] of `n` rays of ``built.scene.emit`` followed by the
    oracle under the scene's options (``np.random`` seeded first)."""
    opts = built.options
    np.random.seed(np_seed)
    fates = np.zeros(11, dtype=np.int64)
    for ray in built.scene.emit(n):
        history = photon_tracer.follow(
            built.scene, ray, maxsteps=opts["maxsteps"],
            maxpathlength=np.inf if opts["maxpathlength"] is None else opts["maxpathlength"],
            emit_method=opts["emit_method"])
        event = history[-1][1]
        # A walk that ends without a fate left every node: NO_HIT.
        fates[event.value if event.value in FATES else 10] += 1
    return fates


@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_twin_matches_oracle_on_random_scene(seed):
    built = random_scene(seed)
    twin = np.asarray(simulate(built.scene, N_TWIN, seed=seed, record_every=0,
                               dtype=np.float64, device="cpu", lanes=1 << 10,
                               **built.options).data["fates"], dtype=np.int64)
    ref = oracle_fates(built, N_ORACLE, seed)
    assert twin.sum() == N_TWIN and ref.sum() == N_ORACLE
    for slot, name in FATES.items():
        p1, p2 = twin[slot] / N_TWIN, ref[slot] / N_ORACLE
        pooled = (twin[slot] + ref[slot]) / (N_TWIN + N_ORACLE)
        z = abs(p1 - p2) / np.sqrt(max(pooled * (1 - pooled) * (1 / N_TWIN + 1 / N_ORACLE),
                                       1e-12))
        assert z < 5, (name, twin.tolist(), ref.tolist())


def test_fixed_seeds_cover_the_generator():
    """Seeds 0-19 hold every geometry, nesting three deep, touching
    faces, every component, emit method, light mask and cap, lights
    inside nodes, every override and recorders with and without a facet;
    every seed's scene is valid (what the oracle and the engine assume):
    siblings' bounding spheres apart, a child's inside its parent's
    inscribed sphere, the touching boxes' faces flush."""
    features = [random_scene(seed).features for seed in CPU_SEEDS]
    union = {key: set() for key in ("geometries", "components", "masks", "caps",
                                    "recorders", "overrides")}
    for f in features:
        for key in union:
            union[key].update(f[key])
    assert union["geometries"] == set(RANDOM_SOLIDS) | set(RANDOM_MESHES)
    assert union["components"] == set(RANDOM_COMPONENTS)
    assert union["masks"] == set(RANDOM_MASKS)
    assert union["caps"] == {"maxsteps", "maxpathlength"}
    assert union["recorders"] == {"facet", "no facet"}
    assert union["overrides"] == {0, 1, 2}
    assert max(f["depth"] for f in features) == 3
    assert {f["touching"] for f in features} >= {2, 3}
    assert sum(f["lights_inside"] for f in features) > 0
    assert {random_scene(seed).options["emit_method"] for seed in CPU_SEEDS} == set(RANDOM_EMIT)
    for seed in CPU_SEEDS + CARD_SEEDS:
        _assert_valid(_random_plan(seed))


def _assert_valid(plan):
    items = plan["items"]
    for c in [None] + list(range(len(items))):
        kids = [j for j, it in enumerate(items) if it["parent"] == c and "centre" in it]
        for a in kids:
            ca, ra = items[a]["centre"], items[a]["rb"]
            if c is not None:
                assert np.linalg.norm(ca) + ra < items[c]["ri"], (c, a)
            else:
                assert np.linalg.norm(ca) + ra < plan["radius"], a
            for b in kids:
                if a < b:
                    gap = np.linalg.norm(ca - items[b]["centre"]) - ra - items[b]["rb"]
                    assert gap > 0, (a, b)
    boxes = [it for it in items if it["name"].startswith("t")]
    for lo, hi in zip(boxes, boxes[1:]):
        top = lo["pose"][2, 3] + lo["dims"][2] / 2
        assert abs(top - (hi["pose"][2, 3] - hi["dims"][2] / 2)) < 1e-12


def test_random_scene_is_reproducible_and_matched_copy_keeps_geometry():
    from pvtrace_tpu_torch.engine import compile_scene

    a, b = compile_scene(random_scene(4).scene), compile_scene(random_scene(4).scene)
    assert a.content_digest == b.content_digest
    m = compile_scene(random_scene(4, matched=True).scene)
    assert m.node_names == a.node_names
    np.testing.assert_array_equal(m.local_to_world, a.local_to_world)
    np.testing.assert_array_equal(m.geom_params, a.geom_params)
    assert (m.refractive_index == 1.0).all() and m.n_components == 0
    assert (m.ovr_mode == -1).all()


class HostEvent:
    """``torch.cuda.Event`` on the host's clock, for the checks on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_checks_give_both_sides_the_run_options(monkeypatch):
    """``check.check_trace``, ``check_log`` and ``check_trace_scores`` hand
    the kernel and the twin the same ``maxsteps``, ``emit_method`` and
    ``maxpathlength``. On CPU tensors the kernel's wrapper runs the twin,
    so each check holds the twin against itself through its own plumbing
    (CUDA events on the host's clock, the card-only placement and pack
    checks stubbed): every trace it makes sees the options it was given,
    and the two sides agree exactly."""
    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tracer
    from pvtrace_tpu_torch.engine.compiler import EMIT_METHODS
    from pvtrace_tpu_torch.kernels import check

    opts = {"maxsteps": 7, "emit_method": EMIT_METHODS["full"], "maxpathlength": 9.5}
    st = scene_tensors(compile_scene(random_scene(4).scene), dtype=torch.float64)
    seen = []

    def spy(fn):
        signature = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            seen.append({k: bound.arguments[k] for k in opts})
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(kernels, "trace", spy(kernels.trace))
    monkeypatch.setattr(tracer, "trace_eager", spy(tracer.trace_eager))
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(check, "check_log_pack", lambda log: {})
    monkeypatch.setattr(check, "check_layout", lambda *args: None)
    words = rng.key_words(4)
    rep = check.check_trace(st, words, 512, lanes=128, **opts)
    assert rep["fates"] == rep["twin_fates"] and rep["fates"][9] > 0
    assert check.check_log(st, words, 256, lanes=128, **opts)["diverged"] == 0
    rep = check.check_trace_scores(st, words, 256, lanes=128, **opts)
    assert rep["fates"] == rep["twin_fates"] and rep["parted"] == 0
    # Kernel runs (each the twin again on the CPU) and twin runs: 2 + 2 + 1
    # of check_trace, 1 + 1 + 1 of check_log, 2 + 2 + 1 of check_trace_scores.
    assert len(seen) == 13 and all(s == opts for s in seen), seen


def test_equal_index_fresnel_partials_are_rounding_noise():
    """At two equal indices the Fresnel partials (``score.fresnel_dR``) are 0
    in exact arithmetic; in float32 they are a cancellation's rounding,
    within the slack's floor FRESNEL_ROUNDING / c^3 down to GRAZING_C (at
    most half of it), and in float64 2**29 times smaller."""
    from pvtrace_tpu_torch.engine import score

    c = torch.logspace(np.log10(score.GRAZING_C), 0.0, 400, dtype=torch.float64)
    for n in (1.05, 1.2271575935333798, 1.5, 1.9):
        for dtype, share in ((torch.float32, 0.5), (torch.float64, 2.0 ** -30)):
            index = torch.full_like(c, n, dtype=dtype)
            for d in score.fresnel_dR(index, index, c.to(dtype)):
                assert bool((d.double().abs() <= share * score.FRESNEL_ROUNDING / c ** 3).all())


def test_lsc_tiles_row_stays_inside_the_world():
    """``lsc_tiles(64)``, phase 38's widest row, lies inside its world
    sphere (a 25 cm world held 45 tiles at most: past that the row's ends
    left it, and the card's and the twin's fates summed to more photons
    than they traced, with a quarter of them NO_HIT)."""
    from pvtrace_tpu_torch.scenes import lsc_tiles

    scene = lsc_tiles(tiles=64, dyes=1)
    radius = scene.root.geometry.radius
    tiles = [n for n in scene.root.iter_preorder() if n.name.startswith("tile")]
    assert len(tiles) == 64
    for node in tiles:
        half = np.asarray(node.geometry.size) / 2.0
        corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]) * half
        pose = node.transformation_to(scene.root)
        world = corners @ pose[:3, :3].T + pose[:3, 3]
        assert np.linalg.norm(world, axis=1).max() < radius, node.name


def test_coincident_faces_in_the_checks():
    """The checks' rule for faces two nodes share (``check``): a record
    whose hit is the other node of a coincident pair, its normal reversed,
    counts as the twin's; a swap between other nodes, or with any other
    field different, does not; the recorders on such nodes and their bins
    are found."""
    from pvtrace_tpu_torch.engine import compile_scene, scene_tensors
    from pvtrace_tpu_torch.kernels import check

    ints = torch.tensor([[[2, 1, 1, 2, -1, 0], [2, 2, 2, 3, -1, 0], [2, 1, 1, 2, -1, 0]]],
                        dtype=torch.int32)
    floats = torch.zeros((1, 3, 12))
    floats[..., 8] = 1.0
    ref = {"ints": ints.clone(), "floats": floats.clone()}
    got_i, got_f = ints.clone(), floats.clone()
    got_i[0, 0, 1], got_f[0, 0, 8] = 2, -1.0      # t0/t1 swapped: equal
    got_i[0, 1, 1], got_f[0, 1, 8] = 3, -1.0      # t1/s2, not coincident
    got_i[0, 2, 1], got_i[0, 2, 5] = 2, 1         # swapped, and a field differs
    out_i, out_f, swapped = check.coincident_hits(got_i, got_f, ref, {1, 2})
    assert swapped == 1 and torch.equal(out_i[0, 0], ints[0, 0])
    assert torch.equal(out_f[0, 0], floats[0, 0])
    assert not torch.equal(out_i[0, 1], ints[0, 1]) and not torch.equal(out_i[0, 2], ints[0, 2])
    built = random_scene(2)
    compiled = compile_scene(built.scene)
    st = scene_tensors(compiled, device="cpu")
    nodes = {compiled.node_names.index(name) for name in built.coincident}
    on, bins = check.coincident_recorders(st, nodes)
    assert on.tolist() == [True, True] and int(bins.sum()) == st["meta"]["total_bins"]
    assert not check.coincident_recorders(st, set())[0].any()


def test_coincident_recorders_held_through_probes():
    """``check.hold_tallies`` on the recorders of touching boxes (seed 2
    with its probes, ``random_scene(probes=True)``), the kernel's side the
    twin's tallies changed: a crossing moved from one probe of a pair to
    the other (the other face hit) passes; a crossing lost from a pair's
    sum fails; a recorder on those nodes off by more than the tolerance and
    the shared-face crossings fails, and one off the nodes by more than the
    tolerance."""
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tracer
    from pvtrace_tpu_torch.kernels import check, crafted

    built = random_scene(2, probes=True)
    compiled = compile_scene(built.scene)
    st = scene_tensors(compiled, dtype=torch.float64)
    faces = crafted.coincident(built, compiled)
    _, _, ref, _ = tracer.trace_eager(st, rng.key_words(2), 2048, lanes=2048,
                                      **crafted.options(built))
    (a, b), _ = faces["probes"]
    assert int(ref["cross"][a] + ref["cross"][b]) > 0

    def held(change):
        got = {k: v.clone() for k, v in ref.items()}
        change(got)
        return check.hold_tallies(got, ref, st, 1, "twin", **faces)

    def swap(got):
        got["cross"][a] += 1
        got["cross"][b] -= 1
    assert held(swap)[2] == 1
    for change in (lambda got: got["cross"].__setitem__(a, got["cross"][a] - 2),
                   lambda got: got["distinct"].__setitem__(2, got["distinct"][2] + 2 + sum(
                       int(ref["cross"][i] + ref["cross"][j]) for i, j in faces["probes"])),
                   ):
        with pytest.raises(AssertionError):
            held(change)
    with pytest.raises(ValueError):
        check.hold_tallies(ref, ref, st, 1, "twin", coincident=faces["coincident"])


def _drifted_log(monkeypatch, seed, dtype, pick):
    """``check.check_log`` on the CPU (the kernel's side the twin) with one
    photon's floats moved by 1e-3 of the scene's scale from a record on, its
    events equal: `pick`(curved [S, E] surface events on curved nodes)
    gives the photon and the record."""
    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors
    from pvtrace_tpu_torch.kernels import check

    built = random_scene(seed)
    st = scene_tensors(compile_scene(built.scene), dtype=dtype)
    real = kernels.trace

    def drifted(*args, **kwargs):
        fates, steps, tallies, log = real(*args, **kwargs)
        ints = log["ints"]
        geom = st["node_i"][:, 0][ints[..., 1].long().clamp(min=0)]
        curved = ((ints[..., 0] == 1) | (ints[..., 0] == 2)) & (ints[..., 1] >= 0) \
            & torch.isin(geom, torch.tensor(check.CURVED, dtype=geom.dtype))
        photon, record = pick(curved)
        log["floats"][photon, record:, :3] += 1e-3 * built.scale
        return fates, steps, tallies, log

    monkeypatch.setattr(kernels, "trace", drifted)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(check, "check_log_pack", lambda log: {})
    opts = {"maxsteps": 1000, "emit_method": 0, "maxpathlength": float("inf")}
    return check.check_log(st, rng.key_words(seed), 1024, lanes=1024, **opts)


def _first_curved(curved, least):
    """A photon whose first curved event is at record `least` or later
    (random scene 9 has boxes beside its spheres and cylinder), and that
    record."""
    index = torch.arange(curved.shape[1])
    first = torch.where(curved, index, curved.shape[1]).amin(1)
    photon = int(torch.nonzero((first >= least) & (first < curved.shape[1]))[0, 0])
    return photon, int(first[photon])


def test_check_log_counts_float32_drift_after_a_curved_surface(monkeypatch):
    """A float32 photon whose floats drift past LOG_RTOL from its first
    event on a curved surface on (a sphere's or a cylinder's: reflections
    there grow a direction's rounding), its events equal, is counted apart
    (``drifted``), within LOG_DRIFTED, and every other photon is still held
    to LOG_RTOL."""
    rep = _drifted_log(monkeypatch, 9, torch.float32, lambda c: _first_curved(c, 2))
    assert (rep["diverged"], rep["drifted"]) == (0, 1) and rep["max_rel_err"] == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_check_log_fails_drift_before_a_curved_surface(monkeypatch, dtype):
    """Floats off by more than the bound before the photon's first event on
    a curved surface fail ``check.check_log`` in float32; in float64 any
    photon whose events are equal is held to F64_RTOL, even after one."""
    if dtype == torch.float32:
        def pick(curved):
            photon, first = _first_curved(curved, 2)
            return photon, first - 1
    else:
        def pick(curved):
            return _first_curved(curved, 1)
    with pytest.raises(AssertionError, match="before any event on a curved surface"
                       if dtype == torch.float32 else "floats off by"):
        _drifted_log(monkeypatch, 9, dtype, pick)


def test_score_records_count_drift_apart():
    """``check.compare_score_records`` on the twin's float64 records of
    random scene 20 against themselves with one photon's record moved (its
    fate and steps equal, as a float32 path drifting on curved surfaces
    leaves them): that photon is ``drifted``, held to `max_drifted` beside
    `max_parted`; a photon whose fate differs counts against `max_parted`
    alone, whatever `max_drifted` allows."""
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tracer
    from pvtrace_tpu_torch.kernels import check, crafted

    built = random_scene(20)
    st = scene_tensors(compile_scene(built.scene), dtype=torch.float64)
    n = 1024
    fates, _, ref, _ = tracer.trace_eager(st, rng.key_words(20), n, lanes=n, score=True,
                                          per_photon=True, **crafted.options(built))
    scores = ref["photon_scores"]
    p, q = (int(i) for i in torch.nonzero(scores.abs().amax(0) > 0)[:2, 0])

    def moved(change):
        got = {k: v.clone() for k, v in ref.items()}
        change(got)
        got["fate_scores"] = torch.zeros_like(got["fate_scores"]).index_add_(
            0, got["photon_fate"], got["photon_scores"].T)
        return got

    def drift(got):
        got["photon_scores"][:, p] += 0.1 * scores.abs().amax(1)

    def refate(got):
        got["photon_fate"][q] = 4 if int(got["photon_fate"][q]) != 4 else 7

    rep = check.compare_score_records(moved(drift), ref, fates, n, 0, max_drifted=1)
    assert (rep["parted"], rep["drifted"]) == (1, 1)
    with pytest.raises(AssertionError, match="1 of them with their fate and steps equal"):
        check.compare_score_records(moved(drift), ref, fates, n, 0)
    with pytest.raises(AssertionError, match="0 of them"):
        check.compare_score_records(moved(refate), ref, fates, n, 0, max_drifted=5)
