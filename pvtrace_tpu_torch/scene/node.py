"""Scene-graph node: a coordinate frame carrying geometry/light/recorders.

Parity: reference ``pvtrace/scene/node.py`` which mixes anytree's
NodeMixin with Transformable. anytree is not a dependency here; the tree
(parent/children wiring, traversal orders, lowest-common-ancestor walks)
is implemented directly.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from pvtrace_tpu_torch.common.errors import AppError
from pvtrace_tpu_torch.geometry.intersection import Intersection
from pvtrace_tpu_torch.geometry.transformable import Transformable
from pvtrace_tpu_torch.geometry.transformations import rotation_from_matrix
from pvtrace_tpu_torch.geometry.utils import distance_between


class Node(Transformable):
    """A node in a scene graph — a coordinate system with position and
    orientation relative to its parent."""

    def __init__(
        self,
        name=None,
        parent=None,
        location=None,
        geometry=None,
        light=None,
        recorders=None,
    ):
        super(Node, self).__init__(location=location)
        self.name = name
        self._parent = None
        self._children = []
        self.parent = parent
        self.geometry = geometry
        self.light = light
        self.recorders = [] if recorders is None else list(recorders)

    def __repr__(self):
        return "Node({})".format(self.name)

    # -- tree wiring ---------------------------------------------------

    @property
    def parent(self):
        return self._parent

    @parent.setter
    def parent(self, new_parent):
        if self._parent is new_parent:
            return
        if self._parent is not None:
            self._parent._children.remove(self)
        self._parent = new_parent
        if new_parent is not None:
            new_parent._children.append(self)

    @property
    def children(self):
        return tuple(self._children)

    @property
    def root(self):
        node = self
        while node._parent is not None:
            node = node._parent
        return node

    @property
    def leaves(self):
        return tuple(n for n in self.iter_preorder() if not n._children)

    @property
    def ancestors(self):
        out = []
        node = self._parent
        while node is not None:
            out.append(node)
            node = node._parent
        return tuple(reversed(out))

    def iter_preorder(self) -> Iterator["Node"]:
        yield self
        for child in self._children:
            yield from child.iter_preorder()

    def iter_postorder(self) -> Iterator["Node"]:
        for child in self._children:
            yield from child.iter_postorder()
        yield self

    def iter_levelorder(self) -> Iterator["Node"]:
        queue = [self]
        while queue:
            node = queue.pop(0)
            yield node
            queue.extend(node._children)

    def walk(self, other: "Node"):
        """(upwards, common, downwards) path decomposition between two
        nodes through their lowest common ancestor (anytree Walker
        semantics)."""
        if self is other:
            return (), self, ()
        mine = (self,) + tuple(reversed(self.ancestors))  # self .. root
        theirs = (other,) + tuple(reversed(other.ancestors))
        their_set = {id(n): i for i, n in enumerate(theirs)}
        for i, node in enumerate(mine):
            j = their_set.get(id(node))
            if j is not None:
                upwards = mine[:i]
                common = node
                downwards = tuple(reversed(theirs[:j]))
                return upwards, common, downwards
        raise AppError("Nodes are not part of the same tree.")

    def path_to(self, node) -> Sequence["Node"]:
        upwards, common, downwards = self.walk(node)
        return tuple(upwards) + (common,) + tuple(downwards)

    # -- orientation ---------------------------------------------------

    def look_at(self, vector: tuple) -> None:
        """Point the node's +z axis along `vector`, rotating about its
        own centre (reference node.py:39-69)."""
        a = np.array([0.0, 0.0, 1.0])
        b = np.asarray(vector, dtype=float)
        c = float(np.dot(a, b))
        if np.isclose(c, -1.0):
            self.rotate(np.pi, [0, 1, 0])
            return
        v = np.cross(a, b)
        C = 1 / (1 + c)
        vx = np.array(
            [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
        )
        r = np.identity(3) + vx + vx @ vx * C
        R = np.identity(4)
        R[:3, :3] = r
        angle, direc, _ = rotation_from_matrix(R)
        self.rotate(angle, direc)

    # -- frame conversion ----------------------------------------------

    def transformation_to(self, node: "Node") -> np.ndarray:
        """Homogeneous matrix converting this node's frame to `node`'s."""
        if self is node:
            return np.identity(4)
        upwards, common, downwards = self.walk(node)
        transforms = tuple(x.pose for x in upwards)
        transforms = transforms + tuple(np.linalg.inv(x.pose) for x in downwards)
        if len(transforms) == 1:
            return transforms[0]
        result = transforms[-1]
        for mat in transforms[-2::-1]:
            result = result @ mat
        return result

    def point_to_node(self, point: tuple, node: "Node") -> tuple:
        """Express a local point in another node's coordinate system."""
        mat = self.transformation_to(node)
        homogeneous = np.ones(4)
        homogeneous[:3] = point
        return tuple(np.dot(mat, homogeneous)[:3])

    def vector_to_node(self, vector: tuple, node: "Node") -> tuple:
        """Express a local vector in another node's coordinate system."""
        mat = self.transformation_to(node)[:3, :3]
        return tuple(np.dot(mat, np.asarray(vector, dtype=float))[:3])

    # -- tracing & emission --------------------------------------------

    def intersections(self, ray_origin, ray_direction) -> Sequence[Intersection]:
        """Intersections of the ray (in this node's frame) with the node's
        geometry and its whole subtree."""
        all_intersections = []
        if self.geometry is not None:
            for point in self.geometry.intersections(ray_origin, ray_direction):
                all_intersections.append(
                    Intersection(
                        coordsys=self,
                        point=point,
                        hit=self,
                        distance=distance_between(ray_origin, point),
                    )
                )
        all_intersections = tuple(all_intersections)
        for child in self._children:
            origin_child = self.point_to_node(ray_origin, child)
            direction_child = self.vector_to_node(ray_direction, child)
            all_intersections = all_intersections + child.intersections(
                origin_child, direction_child
            )
        return all_intersections

    def emit(self, num_rays=None):
        """Generate rays from the node's light in the node's own frame."""
        if self.light is None:
            raise AppError("Not a lighting node.")
        for ray in self.light.emit(num_rays=num_rays):
            yield ray
