"""Homogeneous (4x4) transform math.

Functional parity with the subset of the vendored Gohlke library the
reference actually uses (``pvtrace/geometry/transformations.py``:
``translation_matrix:223``, ``rotation_matrix:303``,
``rotation_from_matrix:351``, ``euler_matrix:1061``) — implemented from
first principles (Rodrigues formula / eigen decomposition), not copied.
"""
import numpy as np


def identity_matrix():
    return np.identity(4)


def translation_matrix(direction):
    """Matrix to translate by vector `direction`."""
    m = np.identity(4)
    m[:3, 3] = direction[:3]
    return m


def translation_from_matrix(matrix):
    return np.array(matrix, copy=True)[:3, 3]


def rotation_matrix(angle, direction, point=None):
    """Matrix to rotate about axis `direction` by `angle` radians.

    When `point` is given the rotation axis passes through it.
    """
    d = np.asarray(direction[:3], dtype=float)
    d = d / np.linalg.norm(d)
    sina = np.sin(angle)
    cosa = np.cos(angle)
    # Rodrigues rotation formula
    r = cosa * np.identity(3)
    r += sina * np.array(
        [[0.0, -d[2], d[1]], [d[2], 0.0, -d[0]], [-d[1], d[0], 0.0]]
    )
    r += (1.0 - cosa) * np.outer(d, d)
    m = np.identity(4)
    m[:3, :3] = r
    if point is not None:
        point = np.asarray(point[:3], dtype=float)
        m[:3, 3] = point - r @ point
    return m


def rotation_from_matrix(matrix):
    """Recover (angle, direction, point) from a rotation matrix.

    Inverse of `rotation_matrix`.
    """
    m = np.asarray(matrix, dtype=float)
    r = m[:3, :3]
    # Axis: eigenvector of R for eigenvalue 1
    w, v = np.linalg.eig(r.T)
    i = np.where(np.abs(np.real(w) - 1.0) < 1e-8)[0]
    if len(i) == 0:
        raise ValueError("Matrix has no rotation axis (not a rotation matrix).")
    direction = np.real(v[:, i[-1]]).squeeze()
    direction = direction / np.linalg.norm(direction)
    # Point: fixed point of the full transform (eigenvector of M for unit
    # eigenvalue, normalised so the homogeneous coordinate is 1).
    w, q = np.linalg.eig(m)
    i = np.where(np.abs(np.real(w) - 1.0) < 1e-8)[0]
    if len(i) == 0:
        raise ValueError("Matrix has no unit eigenvalue.")
    point = np.real(q[:, i[-1]]).squeeze()
    point /= point[3]
    point = point[:3]
    # Angle: from trace, with sign fixed by the axis convention
    cosa = (np.trace(r) - 1.0) / 2.0
    if abs(direction[2]) > 1e-8:
        sina = (r[1, 0] + (cosa - 1.0) * direction[0] * direction[1]) / direction[2]
    elif abs(direction[1]) > 1e-8:
        sina = (r[0, 2] + (cosa - 1.0) * direction[0] * direction[2]) / direction[1]
    else:
        sina = (r[2, 1] + (cosa - 1.0) * direction[1] * direction[2]) / direction[0]
    angle = float(np.arctan2(sina, cosa))
    return angle, direction, point


_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}
_AXIS_VECTORS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _parse_axes(axes):
    """'sxyz'-style convention string -> (static?, axis index triple).

    First letter: 's' composes about FIXED (extrinsic) axes, 'r' about
    the ROTATING (intrinsic) frame. A static a-b-c sequence equals the
    intrinsic c-b-a sequence with the angles reversed, so everything
    reduces to one intrinsic implementation.
    """
    if (
        len(axes) != 4
        or axes[0] not in "sr"
        or any(c not in _AXIS_INDEX for c in axes[1:])
        or axes[1] == axes[2]
        or axes[2] == axes[3]
    ):
        raise ValueError(f"Unknown Euler convention {axes!r}")
    return axes[0] == "s", tuple(_AXIS_INDEX[c] for c in axes[1:])


def _parity(i, j, k):
    """Levi-Civita sign of an axis triple (+1 for xyz, yzx, zxy)."""
    return 1.0 if (j - i) % 3 == 1 else -1.0


def euler_matrix(ai, aj, ak, axes="sxyz"):
    """Matrix from Euler angles in any of the 24 conventions."""
    static, (i, j, k) = _parse_axes(axes)
    if static:
        # static a-b-c == intrinsic c-b-a with reversed angles
        i, j, k = k, j, i
        ai, ak = ak, ai
    return concatenate_matrices(
        rotation_matrix(ai, _AXIS_VECTORS[i]),
        rotation_matrix(aj, _AXIS_VECTORS[j]),
        rotation_matrix(ak, _AXIS_VECTORS[k]),
    )


def _peel_first_angle(m, i, j, k, b, c):
    """Angle of the leading axis-i rotation once b and c are known:
    R_i(a) = M (R_j(b) R_k(c))^-1, read off the axis-i submatrix."""
    rest = (
        rotation_matrix(b, _AXIS_VECTORS[j])
        @ rotation_matrix(c, _AXIS_VECTORS[k])
    )[:3, :3]
    a_mat = m @ rest.T
    lo, hi = (i + 1) % 3, (i + 2) % 3
    return float(np.arctan2(a_mat[hi, lo], a_mat[lo, lo]))


def euler_from_matrix(matrix, axes="sxyz"):
    """Euler angles from a rotation matrix, inverse of `euler_matrix`.

    Near gimbal lock the third angle is pinned to 0 and the first
    absorbs the free degree of freedom (the composed matrix is exact;
    the angle split is the conventional one).
    """
    static, (i, j, k) = _parse_axes(axes)
    if static:
        ak, aj, ai = euler_from_matrix(matrix, "r" + axes[3:0:-1])
        return ai, aj, ak

    m = np.asarray(matrix, dtype=float)[:3, :3]
    eps = 1e-10
    if i == k:
        # Proper Euler sequence i-j-i; third axis only appears in signs.
        third = 3 - i - j
        sign = _parity(i, j, third)
        sb = np.hypot(m[i, j], m[i, third])
        b = float(np.arctan2(sb, m[i, i]))
        if sb > eps:
            c = float(np.arctan2(m[i, j], sign * m[i, third]))
            a = float(np.arctan2(m[j, i], -sign * m[third, i]))
        else:
            c = 0.0
            a = _peel_first_angle(m, i, j, i, b, c)
    else:
        sign = _parity(i, j, k)
        cb = np.hypot(m[i, i], m[i, j])
        b = float(np.arctan2(sign * m[i, k], cb))
        if cb > eps:
            c = float(np.arctan2(-sign * m[i, j], m[i, i]))
            a = float(np.arctan2(-sign * m[j, k], m[k, k]))
        else:
            c = 0.0
            a = _peel_first_angle(m, i, j, k, b, c)
    return a, b, c


def quaternion_from_euler(ai, aj, ak, axes="sxyz"):
    """Quaternion (w, x, y, z) equal to `euler_matrix(ai, aj, ak, axes)`."""
    return quaternion_from_matrix(euler_matrix(ai, aj, ak, axes))


def scale_matrix(factor, origin=None):
    """Uniform scaling by `factor`, about `origin` when given."""
    m = np.identity(4) * float(factor)
    m[3, 3] = 1.0
    if origin is not None:
        origin = np.asarray(origin[:3], dtype=float)
        m[:3, 3] = origin * (1.0 - float(factor))
    return m


def compose_matrix(scale=None, shear=None, angles=None, translate=None):
    """Matrix from the factors `decompose_matrix` returns.

    M = T @ R @ Sh @ Sc with Sc = diag(scale), Sh the unit upper
    triangle holding (xy, xz, yz) shear, R = euler_matrix(*angles,
    'sxyz') and T the translation.
    """
    m = np.identity(4)
    if scale is not None:
        m[0, 0], m[1, 1], m[2, 2] = scale
    if shear is not None:
        sh = np.identity(4)
        sh[0, 1], sh[0, 2], sh[1, 2] = shear
        m = sh @ m
    if angles is not None:
        m = euler_matrix(*angles, axes="sxyz") @ m
    if translate is not None:
        m = translation_matrix(translate) @ m
    return m


def decompose_matrix(matrix):
    """Factor an affine matrix into (scale, shear, angles, translate).

    Inverse of `compose_matrix` (no perspective support — the scene
    graph is affine). Shear is (xy, xz, yz); angles are 'sxyz' Euler.
    Raises ValueError on a singular matrix.
    """
    m = np.asarray(matrix, dtype=float)
    if abs(m[3, 3]) < 1e-14:
        raise ValueError("Matrix is not an affine transform.")
    m = m / m[3, 3]
    translate = m[:3, 3].copy()

    # Gram-Schmidt on the columns: rotation out front, the triangular
    # residue carries scale on the diagonal and shear off it.
    a = m[:3, :3].copy()
    if abs(np.linalg.det(a)) < 1e-14:
        raise ValueError("Matrix is singular.")
    scale = np.zeros(3)
    shear = np.zeros(3)

    scale[0] = np.linalg.norm(a[:, 0])
    a[:, 0] /= scale[0]
    shear[0] = float(a[:, 0] @ a[:, 1])  # xy
    a[:, 1] -= shear[0] * a[:, 0]
    scale[1] = np.linalg.norm(a[:, 1])
    a[:, 1] /= scale[1]
    shear[0] /= scale[1]
    shear[1] = float(a[:, 0] @ a[:, 2])  # xz
    a[:, 2] -= shear[1] * a[:, 0]
    shear[2] = float(a[:, 1] @ a[:, 2])  # yz
    a[:, 2] -= shear[2] * a[:, 1]
    scale[2] = np.linalg.norm(a[:, 2])
    a[:, 2] /= scale[2]
    shear[1] /= scale[2]
    shear[2] /= scale[2]

    if np.linalg.det(a) < 0.0:  # left-handed residue: flip one axis
        scale = -scale
        a = -a
    angles = euler_from_matrix(a, "sxyz")
    return scale, tuple(shear), angles, translate


def concatenate_matrices(*matrices):
    m = np.identity(4)
    for mat in matrices:
        m = m @ np.asarray(mat)
    return m


def quaternion_about_axis(angle, axis):
    """Quaternion (w, x, y, z) for rotation about `axis` by `angle`."""
    a = np.asarray(axis, dtype=float)
    n = np.linalg.norm(a)
    if n == 0.0:
        raise ValueError("Zero-length rotation axis.")
    a = a / n * np.sin(angle / 2.0)
    return np.array([np.cos(angle / 2.0), a[0], a[1], a[2]])


def quaternion_multiply(q1, q0):
    """Hamilton product q1 * q0 of (w, x, y, z) quaternions."""
    w0, x0, y0, z0 = q0
    w1, x1, y1, z1 = q1
    return np.array(
        [
            w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
            w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
            w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
            w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0,
        ]
    )


def quaternion_matrix(quaternion):
    """Homogeneous rotation matrix from a (w, x, y, z) quaternion."""
    q = np.asarray(quaternion, dtype=float)
    n = np.dot(q, q)
    if n < 1e-14:
        return np.identity(4)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array(
        [
            [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
            [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def quaternion_from_matrix(matrix):
    """Quaternion (w, x, y, z) from a rotation matrix (Shepperd)."""
    m = np.asarray(matrix, dtype=float)[:3, :3]
    t = np.trace(m)
    if t > 0.0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (m[2, 1] - m[1, 2]) / (4.0 * w)
        y = (m[0, 2] - m[2, 0]) / (4.0 * w)
        z = (m[1, 0] - m[0, 1]) / (4.0 * w)
    else:
        i = int(np.argmax(np.diagonal(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2.0
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[i + 1] = s / 4.0
        q[j + 1] = (m[j, i] + m[i, j]) / s
        q[k + 1] = (m[k, i] + m[i, k]) / s
        w, x, y, z = q
    quat = np.array([w, x, y, z])
    return quat / np.linalg.norm(quat)


class Arcball:
    """Virtual trackball for mouse-driven 3D rotation.

    Same interface idea as the reference's vendored transformations
    library (reference geometry/transformations.py:1535): `down(point)`
    starts a drag, `drag(point)` updates the rotation, `matrix()`
    returns the homogeneous rotation. Points are (x, y) screen
    coordinates; set `place(center, radius)` to position the ball.
    """

    def __init__(self, initial=None):
        self._center = np.zeros(2)
        self._radius = 1.0
        self._q_down = np.array([1.0, 0.0, 0.0, 0.0])
        self._q_now = (
            np.array([1.0, 0.0, 0.0, 0.0])
            if initial is None
            else quaternion_from_matrix(initial)
        )
        self._v_down = np.array([0.0, 0.0, 1.0])

    def place(self, center, radius):
        self._center = np.asarray(center, dtype=float)
        self._radius = float(radius)

    def _to_sphere(self, point):
        v = (np.asarray(point, dtype=float) - self._center) / self._radius
        d2 = v[0] * v[0] + v[1] * v[1]
        if d2 > 1.0:
            v = v / np.sqrt(d2)
            return np.array([v[0], v[1], 0.0])
        return np.array([v[0], v[1], np.sqrt(1.0 - d2)])

    def down(self, point):
        self._v_down = self._to_sphere(point)
        self._q_down = self._q_now.copy()

    def drag(self, point):
        v_now = self._to_sphere(point)
        axis = np.cross(self._v_down, v_now)
        dot = float(np.clip(np.dot(self._v_down, v_now), -1.0, 1.0))
        if np.linalg.norm(axis) < 1e-12:
            q_drag = np.array([1.0, 0.0, 0.0, 0.0])
        else:
            q_drag = np.concatenate(([dot], axis))
            q_drag = q_drag / np.linalg.norm(q_drag)
            # quaternion with half-angle cos = dot is (cos t, sin t * n);
            # build directly from the rotation between the two vectors
            angle = np.arccos(dot)
            q_drag = quaternion_about_axis(
                angle, axis / np.linalg.norm(axis)
            )
        self._q_now = quaternion_multiply(q_drag, self._q_down)

    def matrix(self):
        return quaternion_matrix(self._q_now)
