"""Scenes the port is checked and measured on."""
import functools

import numpy as np

from pvtrace_tpu_torch import (
    Absorber,
    Box,
    ConstantWavelengthMask,
    Light,
    Luminophore,
    Material,
    Node,
    Scene,
    Sphere,
    cone,
    lumogen_f_red_305,
)


def lsc_slab():
    """The LSC benchmark scene of the JAX package's ``bench.py``: a 5x5x1
    cm slab (n = 1.5) with a Lumogen F Red 305 dye (peak absorption 10
    cm^-1, quantum yield 0.9) and a 0.3 cm^-1 background absorber, in a
    25 cm world sphere, lit by a 555 nm cone (20 degrees) from 3 cm above."""
    x = np.arange(400, 801, dtype=float)
    world = Node(
        name="world",
        geometry=Sphere(radius=25.0, material=Material(refractive_index=1.0)),
    )
    Node(
        name="lsc",
        geometry=Box(
            (5.0, 5.0, 1.0),
            material=Material(
                refractive_index=1.5,
                components=[
                    Luminophore(
                        coefficient=np.column_stack(
                            (x, lumogen_f_red_305.absorption(x) * 10.0)
                        ),
                        emission=np.column_stack((x, lumogen_f_red_305.emission(x))),
                        quantum_yield=0.9,
                        name="dye",
                    ),
                    Absorber(0.3, name="background"),
                ],
            ),
        ),
        parent=world,
    )
    light = Node(
        name="light",
        light=Light(
            direction=functools.partial(cone, np.radians(20)),
            wavelength=ConstantWavelengthMask(555.0),
        ),
        parent=world,
    )
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return Scene(world)
