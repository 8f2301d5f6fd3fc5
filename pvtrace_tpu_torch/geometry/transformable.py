"""Mixin giving objects an incremental pose (4x4 homogeneous matrix).

Parity: reference ``pvtrace/geometry/transformable.py`` — `translate`
composes translations, `rotate` rotates about the object's *current*
location, `location` reads/writes the translation column.
"""
import numpy as np

from pvtrace_tpu_torch.geometry import transformations as tf


class Transformable(object):
    """Object with a location and orientation relative to its parent frame."""

    def __init__(self, location=None):
        super(Transformable, self).__init__()
        if location is None:
            location = (0.0, 0.0, 0.0)
        self._pose = tf.translation_matrix(np.asarray(location, dtype=float))

    @property
    def pose(self):
        return self._pose

    @pose.setter
    def pose(self, new_value):
        self._pose = np.asarray(new_value, dtype=float)

    @property
    def location(self):
        return tuple(self._pose[:3, 3].tolist())

    @location.setter
    def location(self, new_value):
        self._pose[:3, 3] = np.asarray(new_value, dtype=float)

    def translate(self, vector):
        """Apply incremental translation."""
        self._pose = tf.translation_matrix(np.asarray(vector, dtype=float)) @ self._pose

    def rotate(self, angle, axis):
        """Rotate by `angle` radians around `axis` passing through the
        object's current location (reference transformable.py:89)."""
        location = self.location
        self._pose = tf.rotation_matrix(angle, axis, point=location) @ self._pose
