"""Scene tensors: the compiled scene as flat records the tracer reads.

Port of ``CompiledScene.device_tables`` (pvtrace_tpu/engine/compiler.py)
plus the constants the JAX tracer bakes into its program
(pvtrace_tpu/engine/tracer.py ``_run``). The JAX tracer generates code per
scene; the port is table-driven instead: one loop over the node records,
so the same CUDA kernel serves every scene. The eager twin and the CUDA
kernels read the same tensors, with the column layout below. The layout
is mirrored by ``kernels/csrc/tracer.cuh``; the tests compare the two.

Records (rows padded to at least one so no tensor is empty):

* ``node_f`` [N, NODE_F] and ``node_i`` [N, NODE_I], in node order;
* ``comp_f`` [C, COMP_F] and ``comp_i`` [C, COMP_I], in component order
  (a node's components are the contiguous range
  ``[comp_first, comp_first + n_comps)``);
* ``ovr_f`` [O, OVR_F] and ``ovr_i`` [O]: facet overrides, node by node;
* ``light_f`` [nL, LIGHT_F] and ``light_i`` [nL, LIGHT_I];
* the three spectral tables the tracer reads: ``spec_pack`` [N*L, 2W],
  ``ems_icdf_pairs`` [n_lum*M, 2] and ``light_icdf_pairs`` [rows*M, 2].
  The other tables of ``device_tables`` are not read by the tracer.
"""
from types import MappingProxyType

import numpy as np
import torch

from pvtrace_tpu.engine import compiler as comp

# node_f columns
NF_W2L = 0  # 3x4 world-to-local rows, 12 values
NF_L2W = 12  # 3x3 local-to-world rotation, 9 values
NF_GP = 21  # geometry parameters, 3 values
NF_EPS = 24  # forward-hit tolerance
NF_NIDX = 25  # refractive index
NODE_F = 26

# node_i columns
NI_GEOM = 0
NI_SURF = 1
NI_NCOMP = 2
NI_COMP0 = 3
NI_OVR0 = 4
NI_NOVR = 5
NODE_I = 6

# comp_f columns
CF_QY = 0
CF_TAU_RAD = 1
CF_TAU_NR = 2
CF_PHASE = 3  # phase parameter: HG g, or cone half-angle
CF_SIN_PHASE = 4  # sin(cone half-angle), taken in float64
COMP_F = 5

# comp_i columns
CI_TYPE = 0
CI_PHASE = 1  # phase type; HG with |g| < 1e-12 is stored as isotropic
CI_LUM = 2  # emission ICDF row (max(lum_index, 0))
CI_P1 = 3  # kT CDF slot in the node's spec_pack row, -1 if not a luminophore
COMP_I = 4

# ovr_f columns
OF_NX, OF_NY, OF_NZ, OF_ATOL = 0, 1, 2, 3
OVR_F = 4

# light_f columns
LF_WAV = 0  # constant wavelength
LF_POS = 1  # position-mask parameters, 3 values
LF_DIR = 4  # direction parameter (cone half-angle or HG g)
LF_SIN_DIR = 5  # sin(cone half-angle), taken in float64
LF_MAT = 6  # 3x4 local-to-world rows, 12 values
LIGHT_F = 18

# light_i columns
LI_WAV = 0
LI_POS = 1
LI_DIR = 2  # direction kind; HG with |g| < 1e-12 is stored as isotropic
LI_ROW = 3  # light_icdf_pairs row block of a spectrum light
LIGHT_I = 4

LAYOUT = MappingProxyType({
    name: value for name, value in globals().items()
    if name.isupper() and isinstance(value, int)
})


ROW_RECORDS = ("node_f", "node_i", "ovr_f", "ovr_i", "light_f", "light_i")


def _isotropic_if_flat(kind, hg_kind, iso_kind, g):
    return iso_kind if kind == hg_kind and abs(g) < 1e-12 else kind


def unsupported_reason(compiled):
    """Why the port's tracer cannot run `compiled`, or None."""
    if compiled.mesh_data:
        return "triangle meshes (ROADMAP queue 1 item 8, kernel K10)"
    if compiled.n_recorders:
        return "recorders (ROADMAP queue 1 item 4, kernel K9)"
    if not compiled.lights_supported:
        return (
            "lights the compiler cannot lower to device samplers need host "
            "emission (ROADMAP queue 1 item 5)"
        )
    return None


def scene_tensors(compiled, dtype=torch.float32, device="cpu"):
    """Flat tensors of `compiled` in `dtype` on `device` (see module doc).

    Returns a dict of tensors plus ``"meta"``, a dict of the scene-wide
    python scalars (node count, root, grid and ICDF sizes, pack width),
    and ``"rows"``, the small records as python lists.
    """
    reason = unsupported_reason(compiled)
    if reason is not None:
        raise NotImplementedError(f"pvtrace_tpu_torch does not trace {reason}.")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    N = len(compiled.nodes)
    eps = compiled.resolved_eps_per_node(np_dtype)

    node_f = np.zeros((N, NODE_F))
    node_i = np.zeros((N, NODE_I), np.int32)
    ovr_f, ovr_i = [], []
    comp_first = [int(compiled.node_comp_idx[n, 0]) for n in range(N)]
    p1_slot = {}
    for n, (geom, surf, K, comp_ids, lums, ovrs) in enumerate(
        compiled.node_static
    ):
        if K and tuple(comp_ids) != tuple(range(comp_first[n], comp_first[n] + K)):
            raise ValueError("node components must be a contiguous range")
        node_f[n, NF_W2L:NF_W2L + 12] = compiled.world_to_local[n, :3, :4].ravel()
        node_f[n, NF_L2W:NF_L2W + 9] = compiled.local_to_world[n, :3, :3].ravel()
        node_f[n, NF_GP:NF_GP + 3] = compiled.geom_params[n, :3]
        node_f[n, NF_EPS] = eps[n]
        node_f[n, NF_NIDX] = compiled.refractive_index[n]
        node_i[n] = (geom, surf, K, comp_first[n] if K else 0, len(ovr_i), len(ovrs))
        for mode, normal, atol in ovrs:
            ovr_f.append((*normal, atol))
            ovr_i.append(mode)
        for cid, j in lums:
            p1_slot[cid] = K + 2 * j

    comp_f = np.zeros((max(compiled.n_components, 1), COMP_F))
    comp_i = np.zeros((max(compiled.n_components, 1), COMP_I), np.int32)
    for c, (ctype, qy, tau_rad, tau_nr, ptype, pparam, lum) in enumerate(
        compiled.comp_static
    ):
        comp_f[c] = (qy, tau_rad, tau_nr, pparam, np.sin(pparam))
        ptype = _isotropic_if_flat(
            ptype, comp.PHASE_HENYEY_GREENSTEIN, comp.PHASE_ISOTROPIC, pparam
        )
        comp_i[c] = (ctype, ptype, max(lum, 0), p1_slot.get(c, -1))

    C = comp.CompiledScene
    lights = compiled.light_static
    light_f = np.zeros((len(lights), LIGHT_F))
    light_i = np.zeros((len(lights), LIGHT_I), np.int32)
    for li, (wspec, pspec, dspec, matrix) in enumerate(lights):
        dkind = _isotropic_if_flat(dspec[0], C.DIR_HG, C.DIR_ISOTROPIC, dspec[1])
        light_f[li, LF_WAV] = wspec[1] if wspec[0] == C.WAV_CONST else 0.0
        light_f[li, LF_POS:LF_POS + 3] = pspec[1:4]
        light_f[li, LF_DIR] = dspec[1]
        light_f[li, LF_SIN_DIR] = np.sin(dspec[1])
        light_f[li, LF_MAT:LF_MAT + 12] = np.asarray(matrix)[:3, :4].ravel()
        row = int(wspec[1]) if wspec[0] == C.WAV_SPECTRUM else 0
        light_i[li] = (wspec[0], pspec[0], dkind, row)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    out = {
        "node_f": f(node_f),
        "node_i": i(node_i),
        "comp_f": f(comp_f),
        "comp_i": i(comp_i),
        "ovr_f": f(ovr_f if ovr_f else np.zeros((1, OVR_F))),
        "ovr_i": i(ovr_i if ovr_i else [comp.OVR_NONE]),
        "light_f": f(light_f),
        "light_i": i(light_i),
        "spec_pack": f(compiled.spec_pack),
        "ems_icdf_pairs": f(compiled.ems_icdf_pairs),
        "light_icdf_pairs": f(compiled.light_icdf_pairs),
        "meta": {
            "n_nodes": N,
            "root_id": int(compiled.root_id),
            "n_comps": int(compiled.n_components),
            "n_lights": len(lights),
            "n_lum": int(compiled.n_lum),
            "grid_n": int(compiled.grid_n),
            "icdf_n": int(compiled.icdf_n),
            "pack_width": int(compiled.pack_width),
            "grid_x0": float(compiled.grid_x0),
            "grid_dx": float(compiled.grid_dx),
        },
    }
    # The same records as python rows, read once, for the eager twin's
    # loops over nodes, overrides and lights.
    out["rows"] = {name: out[name].tolist() for name in ROW_RECORDS}
    return out
