"""Differentiable transport estimators, the port of
``pvtrace_tpu/diff/transport.py``.

* `fate_gradients`: full multi-bounce gradients of fate fractions from
  one score run of ``engine.simulate`` (K12 inside ``pvt_trace`` on the
  card), in component log-scales and node refractive indices, and with
  ``pathwise=`` in refractive indices and geometry parameters through
  the hybrid pathwise channels (K13 inside ``pvt_trace`` on the card).
* `optimize_concentration`: host-loop gradient descent on one
  component's log-scale with those gradients.
* `absorbed_fraction_fn`: the first-pass Beer–Lambert surrogate (K15,
  ``pvt_absorbed`` on the card), differentiable in
  ``params["log_concentration"]`` through ``torch.autograd``.
* `make_training_step`: an SGD step on the dye concentration with that
  surrogate, the photon batch split over a process group and the loss's
  sums and the gradient all-reduced (K14, ``parallel/``).

``fate_gradients(mesh=...)`` shards each bundle over a process group
(``parallel.shard_simulate``), as the JAX package shards it over a device
mesh.
"""
import numpy as np
import torch
import torch.distributed as dist

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.engine import absorb
from pvtrace_tpu_torch.engine import compiler as comp
from pvtrace_tpu_torch.engine.api import simulate
from pvtrace_tpu_torch.engine.compiler import compile_scene
from pvtrace_tpu_torch.light.event import Event


def resolve_pathwise_params(compiled, params):
    """Map user parameter specs to tracer channel specs.

    Accepted spec forms (node by name or preorder index):

    - ``("n", node)`` — refractive index;
    - ``("size", node, axis)`` — box edge length along ``axis``;
    - ``("radius", node)`` — sphere or cylinder radius;
    - ``("length", node)`` — cylinder length.
    """
    resolved = []
    for spec in params:
        kind = spec[0]
        node = spec[1]
        if not isinstance(node, int):
            node = compiled.node_names.index(node)
        gtype = int(compiled.geom_type[node])
        if kind == "n":
            resolved.append(("n", node))
        elif kind == "size":
            if gtype != comp.GEOM_BOX:
                raise ValueError(f"'size' needs a Box node, got type {gtype}")
            resolved.append(("geom", node, int(spec[2])))
        elif kind == "radius":
            if gtype == comp.GEOM_SPHERE:
                resolved.append(("geom", node, 0))
            elif gtype == comp.GEOM_CYLINDER:
                resolved.append(("geom", node, 1))
            else:
                raise ValueError(
                    f"'radius' needs a Sphere or Cylinder node, got {gtype}"
                )
        elif kind == "length":
            if gtype != comp.GEOM_CYLINDER:
                raise ValueError(f"'length' needs a Cylinder node, got {gtype}")
            resolved.append(("geom", node, 0))
        else:
            raise ValueError(f"Unknown pathwise parameter kind {kind!r}")
    return tuple(resolved)


def fate_gradients(scene, num_rays, seed=None, wrt="components",
                   pathwise=None, bundle=16_000_000, center=True,
                   mesh=None, **kwargs):
    """Full multi-bounce gradients of fate fractions from ONE run.

    Score-function (likelihood-ratio) estimator: every free-path sample,
    component roulette and Fresnel coin flip contributes d log p(path) /
    d theta, and at termination the path score goes into its fate's
    accumulator, so d P(fate) / d theta = E[1{fate} * score_theta].

    Returns (fractions, gradients): ``fractions[Event]`` is the fate
    fraction; ``gradients[Event]`` depends on ``wrt``:

    - ``"components"`` (default): [n_components], d fraction / d log(component
      coefficient scale);
    - ``"refractive_index"``: [n_nodes], d fraction / d n_k from the Fresnel
      reflect/transmit probabilities (the Snell bending of transmitted
      directions is not differentiated: the full derivative at normal
      incidence, the probability-path partial otherwise);
    - ``"all"``: both blocks concatenated, then the pathwise block;
    - ``"pathwise"``: [len(pathwise)], the hybrid pathwise channels of the
      parameters in `pathwise` (``resolve_pathwise_params`` has the spec
      forms). An ``("n", node)`` channel is the complete derivative at any
      incidence: its Fresnel coin term takes the full dR, and boundary
      motion enters through the free-flight survival and collision
      likelihoods, with position and direction tangents carried photon by
      photon through every reflection and refraction.

    ``bundle`` caps the photons per ``simulate`` call; the [fate, channel]
    sums of the bundles are added in float64 on the host. ``center=True``
    subtracts the zero-expectation control variate p_fate * mean(score).
    kwargs pass through to ``engine.simulate`` (lanes, dtype, device, ...):
    the run is on the card unless ``device="cpu"``.

    ``mesh`` (``parallel.make_photon_mesh()``) shards each bundle's photon
    axis over a process group through ``parallel.shard_simulate``, on
    ``mesh.device``: each rank traces its slice and the score sums are
    all-reduced. `num_rays` must be a multiple of the mesh size, and
    `bundle` is rounded down to one. Per-photon keys fold the global
    photon index, so the sharded estimator equals the single-process one
    (fate counts bit for bit, score sums up to summation order).
    """
    compiled = kwargs.pop("compiled", None)
    if compiled is None:
        compiled = compile_scene(scene)
    pw = resolve_pathwise_params(compiled, pathwise) if pathwise else ()
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if mesh is not None:
        from pvtrace_tpu_torch.parallel.shard import shard_simulate

        n_dev = mesh.size
        if num_rays % n_dev != 0:
            raise ValueError(
                f"num_rays ({num_rays}) must be a multiple of the mesh size ({n_dev})."
            )
        if bundle:
            bundle = max(n_dev, bundle - bundle % n_dev)

    n_comps = int(compiled.n_components)
    n_nodes = len(compiled.nodes)
    scores_sum = None
    fates_sum = None
    traced = 0
    while traced < num_rays:
        n_call = num_rays - traced if not bundle else min(bundle, num_rays - traced)
        if mesh is not None:
            data = shard_simulate(
                scene, n_call, mesh, seed=seed, index_offset=traced, score=True, pathwise=pw,
                compiled=compiled, **kwargs
            )
        else:
            data = simulate(
                scene, n_call, seed=seed, index_offset=traced, record_every=0, score=True,
                pathwise=pw, compiled=compiled, **kwargs
            ).data
        part = np.asarray(data["fate_scores"], dtype=np.float64)
        fate_part = np.asarray(data["fates"], dtype=np.float64)
        scores_sum = part if scores_sum is None else scores_sum + part
        fates_sum = fate_part if fates_sum is None else fates_sum + fate_part
        traced += n_call

    scores = _slice_channels(scores_sum, n_comps, wrt, n_nodes=n_nodes)
    if center:
        total_score = scores.sum(axis=0, keepdims=True)
        scores = scores - fates_sum[:, None] / num_rays * total_score
    fractions, gradients = {}, {}
    for event in (Event.EXIT, Event.NONRADIATIVE, Event.REACT, Event.KILL):
        fractions[event] = fates_sum[event.value] / num_rays
        gradients[event] = scores[event.value] / num_rays
    return fractions, gradients


def _slice_channels(scores, n_comps, wrt, n_nodes=None):
    """Select score channels: components block, node-n block, pathwise
    block, or everything."""
    if wrt == "components":
        return scores[..., :n_comps]
    if wrt == "refractive_index":
        if n_nodes is None:
            return scores[..., n_comps:]
        return scores[..., n_comps:n_comps + n_nodes]
    if wrt == "pathwise":
        if n_nodes is None:
            raise ValueError("wrt='pathwise' requires channel counts")
        return scores[..., n_comps + n_nodes:]
    if wrt == "all":
        return scores
    raise ValueError(
        "wrt must be 'components', 'refractive_index', 'pathwise' or "
        f"'all'; got {wrt!r}"
    )


def _absorbing_nodes(compiled):
    return absorb.absorbing_nodes(compiled)


class _AbsorbedFraction(torch.autograd.Function):
    """K15 with its gradient: forward ``kernels.absorbed`` (weights, and
    the optical depths it keeps), backward ``kernels.absorbed_grad`` (the
    gradient in log_concentration). Only log_concentration gets a
    gradient."""

    @staticmethod
    def forward(ctx, log_concentration, tab, pos, direction, wav):
        c = torch.exp(log_concentration).reshape(1)
        w, dep = kernels.absorbed(tab, pos, direction, wav, c)
        ctx.save_for_backward(c, dep)
        ctx.shape = log_concentration.shape
        return w

    @staticmethod
    def backward(ctx, grad_w):
        c, dep = ctx.saved_tensors
        g = kernels.absorbed_grad(dep, grad_w.contiguous(), c)
        return g.reshape(ctx.shape), None, None, None, None


def absorbed_fraction_fn(compiled):
    """Returns fn(params, pos, dir, wav) -> per-photon absorbed weight.

    First-pass straight-line Beer-Lambert estimator, differentiable
    w.r.t. params["log_concentration"] (a global scale on every
    absorbing component): the optical depth sums c * alpha_n(lambda) *
    chord_n over EVERY absorbing node, assuming unbent rays — exact for
    index-matched scenes, a smooth surrogate otherwise (use
    `fate_gradients` for the full multi-bounce estimator).

    `pos` and `dir` are [P, 3] and `wav` [P], world frame, and
    ``params["log_concentration"]`` a scalar tensor, all of one dtype
    (float32 or float64) on one device: on the card the weights come from
    the kernel ``pvt_absorbed`` of the build of that dtype and their
    gradient from its backward kernel, on the CPU from the plain twin
    (``engine/absorb.py``). ``torch.autograd`` gives the gradient in
    log_concentration only: `pos`, `dir` and `wav` get None.
    """
    tables = {}

    def weight(params, pos, direction, wav):
        key = (pos.device, pos.dtype)
        if key not in tables:
            tables[key] = absorb.table(compiled, *key)
        return _AbsorbedFraction.apply(params["log_concentration"], tables[key], pos,
                                       direction, wav)

    return weight


def optimize_concentration(scene_builder, target, num_rays=200_000,
                           iters=6, lr=4.0, seed=0, component=0,
                           event=None, verbose=False, **kwargs):
    """Host-loop gradient descent on log(dye concentration) using the
    unbiased multi-bounce score estimator (no straight-line surrogate).

    `scene_builder(scale)` must rebuild the scene with every absorbing
    coefficient of the target component multiplied by `scale`. Each
    iteration traces `num_rays` (on the card unless ``device="cpu"`` is
    in kwargs), reads P(fate) and dP/dlog(scale) from one score run, and
    descends the squared error to `target`.

    Returns (log_scale, history) with history rows
    (log_scale, fraction, loss).
    """
    if event is None:
        event = Event.NONRADIATIVE
    log_scale = 0.0
    history = []
    for i in range(iters):
        scene = scene_builder(float(np.exp(log_scale)))
        fractions, gradients = fate_gradients(
            scene, num_rays, seed=seed + i, **kwargs
        )
        p = float(fractions[event])
        g = float(gradients[event][component])
        loss = (p - target) ** 2
        history.append((log_scale, p, loss))
        if verbose:
            print(f"iter {i}: log_scale={log_scale:+.4f} "
                  f"P={p:.4f} loss={loss:.6f}")
        log_scale -= lr * 2.0 * (p - target) * g
    return log_scale, history


def make_training_step(compiled, mesh, axis_name="photons", target=0.8, lr=0.1):
    """An SGD step on the dye concentration with the photon batch split
    over `mesh` (``parallel.make_photon_mesh()``).

    fn(params, pos, dir, wav, key=None) -> (new_params, loss): each rank
    passes its slice of the photons (`pos` and `dir` [P, 3], `wav` [P], on
    its device) and the same `params` (``{"log_concentration": a scalar
    tensor}``), all float32 or all float64. With w the Beer–Lambert weight of
    `absorbed_fraction_fn` (``pvt_absorbed`` on the card), the loss is
    (Σw / Σcount − target)², both sums over every rank's photons; the
    gradient is each rank's ``torch.autograd.grad`` of its own Σw
    (``pvt_absorbed_grad``), summed over the ranks, times 2(mean −
    target)/Σcount, which is what the JAX package's ``value_and_grad``
    through its ``psum`` computes; then one step of size `lr`. The three
    sums, in the photons' dtype, go through one all-reduce (NCCL on the
    card, gloo on CPU copies). `key` is accepted, as the JAX step's, and unused.

    NOTE: the loss differentiates the first-pass straight-line surrogate:
    exact for index-matched scenes, biased where refraction bends rays
    (use `fate_gradients` / `optimize_concentration` for the unbiased
    multi-bounce gradients).
    """
    weight = absorbed_fraction_fn(compiled)

    def step(params, pos, direction, wav, key=None):
        log_c = params["log_concentration"].detach().requires_grad_(True)
        w = weight({"log_concentration": log_c}, pos, direction, wav)
        local = w.sum()
        (g_local,) = torch.autograd.grad(local, log_c)
        count = torch.tensor(float(w.shape[0]), device=w.device, dtype=w.dtype)
        sums = torch.stack([local.detach(), count, g_local.reshape(()).to(w.dtype)])
        if mesh.group is not None:
            on_card = dist.get_backend(mesh.group) == "nccl"
            buf = sums if on_card else sums.cpu()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
            sums = buf.to(w.device)
        total, count, grad = sums.unbind(0)
        mean = total / count
        loss = (mean - target) ** 2
        grad = 2.0 * (mean - target) / count * grad
        new = (log_c.detach() - lr * grad).reshape(params["log_concentration"].shape)
        return {"log_concentration": new}, loss

    return step
