"""Triangle-mesh geometry with a built-in Möller–Trumbore intersector.

Parity: reference ``pvtrace/geometry/mesh.py`` which wraps trimesh
(optionally embree). This implementation has no external dependency: a
vectorised numpy Möller–Trumbore solve over all faces (meshes in this
domain are small — reference docs mkdocs/docs/units.md warn trimesh is
single precision; we are float64 here). A native C++ kernel can be used
as a drop-in accelerator (see pvtrace_tpu/native).

The mesh is recentred on its centroid at construction, like the
reference (mesh.py:17).
"""
import numpy as np

from pvtrace_tpu_torch.common.errors import GeometryError
from pvtrace_tpu_torch.geometry.geometry import Geometry
from pvtrace_tpu_torch.geometry.utils import EPS_ZERO


def _as_vertices_faces(mesh):
    """Accept (vertices, faces) tuple, a trimesh-like object, or an STL path."""
    if isinstance(mesh, (tuple, list)) and len(mesh) == 2:
        return np.asarray(mesh[0], dtype=float), np.asarray(mesh[1], dtype=np.int64)
    if hasattr(mesh, "vertices") and hasattr(mesh, "faces"):
        return (
            np.asarray(mesh.vertices, dtype=float),
            np.asarray(mesh.faces, dtype=np.int64),
        )
    if isinstance(mesh, str):
        return load_stl(mesh)
    raise ValueError(
        "Mesh requires (vertices, faces), a trimesh-like object, or an STL path."
    )


def load_stl(path):
    """Minimal STL reader (binary and ascii) returning (vertices, faces)."""
    with open(path, "rb") as fh:
        header = fh.read(80)
        rest = fh.read()
    is_ascii = header.lstrip().startswith(b"solid") and b"facet" in rest[:1000]
    tris = []
    if is_ascii:
        text = (header + rest).decode("ascii", errors="ignore")
        current = []
        for line in text.splitlines():
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                current.append([float(v) for v in parts[1:]])
                if len(current) == 3:
                    tris.append(current)
                    current = []
    else:
        count = int(np.frombuffer(rest[:4], dtype="<u4")[0])
        data = np.frombuffer(rest[4 : 4 + count * 50], dtype=np.uint8)
        data = data.reshape(count, 50)
        floats = data[:, :48].copy().view("<f4").reshape(count, 4, 3)
        tris = floats[:, 1:4, :].astype(float)
    tris = np.asarray(tris, dtype=float)
    vertices = tris.reshape(-1, 3)
    faces = np.arange(len(vertices), dtype=np.int64).reshape(-1, 3)
    return vertices, faces


class Mesh(Geometry):
    """Arbitrary closed triangle mesh."""

    def __init__(self, mesh, material=None):
        super(Mesh, self).__init__()
        vertices, faces = _as_vertices_faces(mesh)
        # Recentre on the centroid (reference recentres on centre of mass)
        centroid = vertices.mean(axis=0)
        self.vertices = vertices - centroid
        self.faces = faces
        self._material = material
        # Precompute triangle data
        self._v0 = self.vertices[self.faces[:, 0]]
        e1 = self.vertices[self.faces[:, 1]] - self._v0
        e2 = self.vertices[self.faces[:, 2]] - self._v0
        self._e1 = e1
        self._e2 = e2
        n = np.cross(e1, e2)
        mags = np.linalg.norm(n, axis=1)
        mags[mags == 0.0] = 1.0
        self._face_normals = n / mags[:, None]
        # This copy keeps only the numpy Moller-Trumbore path (the JAX
        # package's native C++ kernel is not part of the port).
        self._kernel = None

    @property
    def material(self):
        return self._material

    @material.setter
    def material(self, new_value):
        self._material = new_value

    # -- ray casting ---------------------------------------------------

    def _ray_hits(self, origin, direction):
        """All (t, face) intersections via Möller–Trumbore."""
        if self._kernel is not None:
            return self._kernel.ray_hits(
                np.asarray(origin, float), np.asarray(direction, float),
                t_min=-np.inf,
            )
        o = np.asarray(origin, dtype=float)
        d = np.asarray(direction, dtype=float)
        pvec = np.cross(d, self._e2)
        det = np.einsum("ij,ij->i", self._e1, pvec)
        ok = np.abs(det) > 1e-14
        inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o - self._v0
        u = np.einsum("ij,ij->i", tvec, pvec) * inv_det
        qvec = np.cross(tvec, self._e1)
        v = np.einsum("j,ij->i", d, qvec) * inv_det
        t = np.einsum("ij,ij->i", self._e2, qvec) * inv_det
        hit = ok & (u >= -1e-12) & (v >= -1e-12) & (u + v <= 1.0 + 1e-12)
        return t[hit], np.where(hit)[0]

    def intersections(self, origin, direction):
        ts, _ = self._ray_hits(origin, direction)
        ts = np.sort(ts[ts >= 0.0])
        # Deduplicate hits on shared triangle edges
        keep = []
        for t in ts:
            if not keep or t - keep[-1] > EPS_ZERO:
                keep.append(float(t))
        o = np.asarray(origin, dtype=float)
        d = np.asarray(direction, dtype=float)
        return tuple(tuple((o + t * d).tolist()) for t in keep)

    def contains(self, point):
        if self._kernel is not None:
            return self._kernel.contains(np.asarray(point, float), eps=EPS_ZERO)
        direction = np.array([0.577350269189626, 0.577350269189626, 0.577350269189626])
        ts, _ = self._ray_hits(point, direction)
        forward = ts[ts > EPS_ZERO]
        # Deduplicate edge-shared hits
        forward = np.sort(forward)
        count = 0
        last = -np.inf
        for t in forward:
            if t - last > EPS_ZERO:
                count += 1
            last = t
        return bool(count % 2 == 1)

    def is_on_surface(self, point):
        return self._nearest_face(point)[1] < 10 * EPS_ZERO

    def _nearest_face(self, point):
        """(face index, distance) of the closest triangle to `point`."""
        if self._kernel is not None:
            return self._kernel.nearest_face(np.asarray(point, float))
        p = np.asarray(point, dtype=float)
        # Project p onto each triangle plane then clamp barycentrics
        w = p - self._v0
        a = np.einsum("ij,ij->i", self._e1, self._e1)
        b = np.einsum("ij,ij->i", self._e1, self._e2)
        c = np.einsum("ij,ij->i", self._e2, self._e2)
        d1 = np.einsum("ij,ij->i", self._e1, w)
        d2 = np.einsum("ij,ij->i", self._e2, w)
        det = a * c - b * b
        det = np.where(np.abs(det) < 1e-300, 1e-300, det)
        u = np.clip((c * d1 - b * d2) / det, 0.0, 1.0)
        v = np.clip((a * d2 - b * d1) / det, 0.0, 1.0)
        scale = np.clip(u + v, 1.0, None)
        u, v = u / scale, v / scale
        closest = self._v0 + u[:, None] * self._e1 + v[:, None] * self._e2
        dists = np.linalg.norm(closest - p, axis=1)
        idx = int(np.argmin(dists))
        return idx, float(dists[idx])

    def normal(self, surface_point):
        idx, dist = self._nearest_face(surface_point)
        if dist > 1e-6:
            raise GeometryError("Not a surface point.", {"point": surface_point})
        return tuple(self._face_normals[idx].tolist())

    def is_entering(self, surface_point, direction) -> bool:
        normal = self.normal(surface_point)
        return bool(np.dot(normal, direction) < 0.0)
