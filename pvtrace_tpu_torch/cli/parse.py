"""YAML scene specification parser.

Parity: reference ``pvtrace/cli/parse.py`` — same declarative format
(version "1.0": nodes with box/cylinder/sphere/mesh/light, components
absorber/scatterer/luminophore with CSV-file or named spectra,
recorders, ``record: true`` auto-instrumentation). Specs are validated
against a Draft-07 JSON schema before parsing.
"""
import json
import os
from typing import Optional

import numpy as np

from pvtrace_tpu_torch.data import fluro_red, lumogen_f_red_305
from pvtrace_tpu_torch.engine.recorder import Heatmap, Histogram, Recorder
from pvtrace_tpu_torch.geometry.box import Box
from pvtrace_tpu_torch.geometry.cylinder import Cylinder
from pvtrace_tpu_torch.geometry.mesh import Mesh
from pvtrace_tpu_torch.geometry.sphere import Sphere
from pvtrace_tpu_torch.light.light import (
    CircularMask,
    ConstantWavelengthMask,
    CubeMask,
    Light,
    RectangularMask,
    SpectrumWavelengthMask,
)
from pvtrace_tpu_torch.material.component import Absorber, Luminophore, Scatterer
from pvtrace_tpu_torch.material.distribution import Distribution
from pvtrace_tpu_torch.material.material import Material
from pvtrace_tpu_torch.material.utils import (
    Cone,
    HenyeyGreenstein,
    isotropic,
    lambertian,
)
from pvtrace_tpu_torch.scene.node import Node
from pvtrace_tpu_torch.scene.scene import Scene

SCHEMA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "schema.json")

SPECTRUM_MODULES = {
    "lumogen-f-red-305": lumogen_f_red_305,
    "fluro-red": fluro_red,
}


def load_schema():
    import jsonschema

    with open(SCHEMA, "r") as fp:
        schema = json.load(fp)
    jsonschema.Draft7Validator.check_schema(schema)
    return schema


def load_spec(filename):
    import yaml

    with open(filename, "r") as fp:
        return yaml.safe_load(fp)


def parse(filename: str) -> Scene:
    """Parse and validate a YAML scene file into a Scene."""
    import jsonschema

    spec = load_spec(filename)
    jsonschema.validate(spec, schema=load_schema())
    version = spec["version"]
    if version != "1.0":
        raise ValueError("Version {} not supported".format(version))
    return _SpecParser(os.path.dirname(filename)).parse(spec)


class _SpecParser:
    def __init__(self, working_directory):
        self.cwd = working_directory

    # -- spectra -------------------------------------------------------

    def load_csv_spectrum(self, filename) -> np.ndarray:
        import pandas

        if not os.path.isabs(filename):
            filename = os.path.abspath(os.path.join(self.cwd, filename))
        df = pandas.read_csv(filename, usecols=[0, 1, 2], index_col=0)
        return df.iloc[:, 0:2].values

    def load_named_spectrum(self, spec, named_type) -> np.ndarray:
        rng = spec["range"]
        x = np.arange(rng["min"], rng["max"] + rng["spacing"], rng["spacing"])
        module = SPECTRUM_MODULES[spec["name"]]
        if named_type == "absorption":
            return np.column_stack((x, module.absorption(x)))
        if named_type == "emission":
            return np.column_stack((x, module.emission(x)))
        raise ValueError("Requires named type")

    def spectrum(self, spec, named_type=None) -> Optional[np.ndarray]:
        if spec is None:
            return None
        if "file" in spec:
            return self.load_csv_spectrum(spec["file"])
        if "name" in spec:
            return self.load_named_spectrum(spec, named_type)
        return None

    # -- direction samplers / phase functions -------------------------

    def direction_sampler(self, spec):
        if isinstance(spec, str):
            if spec == "isotropic":
                return isotropic
            if spec == "lambertian":
                return lambertian
            raise ValueError(f"Unknown phase function {spec!r}")
        if "isotropic" in spec:
            return isotropic
        if "lambertian" in spec:
            return lambertian
        if "cone" in spec:
            half_angle = float(spec["cone"]["half-angle"])  # degrees
            return Cone(float(np.radians(half_angle)))
        if "henyey-greenstein" in spec:
            return HenyeyGreenstein(float(spec["henyey-greenstein"]["g"]))
        raise ValueError("Missing attribute")

    # -- components ----------------------------------------------------

    @staticmethod
    def _scaled(spectrum, coefficient):
        spectrum = np.array(spectrum, dtype=float)
        spectrum[:, 1] = spectrum[:, 1] / np.max(spectrum[:, 1]) * coefficient
        return spectrum

    def absorber(self, spec, name):
        coefficient = spec.get("coefficient")
        hist = spec.get("hist", False)
        spectrum = self.spectrum(spec.get("spectrum"), named_type="absorption")
        if coefficient is not None and spectrum is not None:
            return Absorber(self._scaled(spectrum, coefficient), name=name, hist=hist)
        if spectrum is not None:
            return Absorber(spectrum, name=name, hist=hist)
        if coefficient is not None:
            return Absorber(coefficient, name=name)
        raise ValueError("Unexpected absorber format.")

    def scatterer(self, spec, name):
        coefficient = spec.get("coefficient")
        hist = spec.get("hist", False)
        quantum_yield = spec.get("quantum-yield", 1.0)
        phase_function = None
        if "phase-function" in spec:
            phase_function = self.direction_sampler(spec["phase-function"])
        spectrum = self.spectrum(spec.get("spectrum"), named_type="absorption")
        kwargs = dict(
            quantum_yield=quantum_yield,
            phase_function=phase_function,
            name=name,
            hist=hist,
        )
        if coefficient is not None and spectrum is not None:
            return Scatterer(self._scaled(spectrum, coefficient), **kwargs)
        if spectrum is not None:
            return Scatterer(spectrum, **kwargs)
        if coefficient is not None:
            return Scatterer(coefficient, **kwargs)
        raise ValueError("Unexpected scatterer format.")

    def luminophore(self, spec, name):
        absorption = spec["absorption"]
        emission = spec.get("emission", {})
        hist = spec.get("hist", False)
        coefficient = absorption.get("coefficient")
        quantum_yield = emission.get("quantum-yield", 1.0)
        phase_function = isotropic
        if "phase-function" in emission:
            phase_function = self.direction_sampler(emission["phase-function"])
        absorption_spectrum = self.spectrum(
            absorption.get("spectrum"), named_type="absorption"
        )
        emission_spectrum = self.spectrum(
            emission.get("spectrum"), named_type="emission"
        )
        if emission_spectrum is None:
            raise ValueError("Luminophore must have an emission spectrum")
        kwargs = dict(
            emission=emission_spectrum,
            quantum_yield=quantum_yield,
            phase_function=phase_function,
            name=name,
            hist=hist,
        )
        if coefficient is not None and absorption_spectrum is not None:
            return Luminophore(
                self._scaled(absorption_spectrum, coefficient), **kwargs
            )
        if absorption_spectrum is not None:
            return Luminophore(absorption_spectrum, **kwargs)
        if coefficient is not None:
            return Luminophore(coefficient, **kwargs)
        raise ValueError("Unexpected luminophore format.")

    def component(self, spec, name):
        if "absorber" in spec:
            return self.absorber(spec["absorber"], name)
        if "scatterer" in spec:
            return self.scatterer(spec["scatterer"], name)
        if "luminophore" in spec:
            return self.luminophore(spec["luminophore"], name)
        raise ValueError("Unknown component type")

    # -- materials and geometry ---------------------------------------

    def material(self, spec, component_map):
        component_keys = spec.get("components", [])
        for key in component_keys:
            if key not in component_map:
                raise ValueError(f"Missing {key} component")
        return Material(
            refractive_index=spec["refractive-index"],
            components=[component_map[k] for k in component_keys],
        )

    def geometry(self, spec, component_map):
        if "box" in spec:
            sub = spec["box"]
            return Box(
                size=sub["size"], material=self.material(sub["material"], component_map)
            )
        if "sphere" in spec:
            sub = spec["sphere"]
            return Sphere(
                radius=sub["radius"],
                material=self.material(sub["material"], component_map),
            )
        if "cylinder" in spec:
            sub = spec["cylinder"]
            return Cylinder(
                length=sub["length"],
                radius=sub["radius"],
                material=self.material(sub["material"], component_map),
            )
        if "mesh" in spec:
            sub = spec["mesh"]
            filename = sub["file"]
            if not os.path.isabs(filename):
                filename = os.path.join(self.cwd, filename)
            return Mesh(
                filename, material=self.material(sub["material"], component_map)
            )
        return None

    # -- lights --------------------------------------------------------

    def light(self, spec, name):
        wavelength = None
        if spec.get("wavelength") is not None:
            wavelength = ConstantWavelengthMask(spec["wavelength"])
        position = None
        direction = None
        mask = spec.get("mask")
        if mask:
            wspec = mask.get("wavelength")
            if wspec:
                if "nanometers" in wspec:
                    wavelength = ConstantWavelengthMask(wspec["nanometers"])
                elif "spectrum" in wspec:
                    spectrum = self.spectrum(
                        wspec["spectrum"], named_type="absorption"
                    )
                    wavelength = SpectrumWavelengthMask(
                        Distribution(spectrum[:, 0], spectrum[:, 1])
                    )
            pspec = mask.get("position")
            if pspec:
                if "rect" in pspec:
                    position = RectangularMask(*pspec["rect"])
                elif "cube" in pspec:
                    position = CubeMask(*pspec["cube"])
                elif "circle" in pspec:
                    position = CircularMask(pspec["circle"])
            dspec = mask.get("direction")
            if dspec:
                direction = self.direction_sampler(dspec)
        return Light(
            position=position, direction=direction, wavelength=wavelength, name=name
        )

    # -- assembly ------------------------------------------------------

    def parse(self, spec) -> Scene:
        component_map = {}
        for name, sub in (spec.get("components") or {}).items():
            component_map[name] = self.component(sub, name)

        nodes = {}
        frames = {}
        for name, sub in spec["nodes"].items():
            geometry = self.geometry(sub, component_map)
            if geometry is not None:
                nodes[name] = Node(geometry=geometry, name=name)
            elif "light" in sub:
                nodes[name] = Node(light=self.light(sub["light"], name), name=name)
            else:
                raise ValueError(f"Node {name!r} has no geometry or light.")
            frames[name] = {
                "parent": sub.get("parent"),
                "location": sub.get("location"),
                "direction": sub.get("direction"),
            }

        for name, node in nodes.items():
            frame = frames[name]
            if name == "world":
                node.parent = None
            elif frame["parent"] is None:
                node.parent = nodes["world"]
            else:
                node.parent = nodes[frame["parent"]]
            if frame["location"]:
                node.location = frame["location"]
            if frame["direction"]:
                node.look_at(frame["direction"])

        recorders_spec = dict(spec.get("recorders", {}) or {})
        for node_name, node_spec in spec["nodes"].items():
            if node_spec.get("record"):
                for rec_name, rec in auto_recorders(node_name, node_spec).items():
                    recorders_spec.setdefault(rec_name, rec)
        parse_recorders(recorders_spec, nodes)

        return Scene(nodes["world"])


def auto_recorders(node_name: str, node_spec: dict) -> dict:
    """Default instrumentation for ``record: true`` on a node: per-face
    escaping heatmaps for boxes (whole-surface recorders otherwise) plus
    a volume loss recorder. Explicit entries with the same name win."""
    wavelength = [300.0, 1000.0, 100]
    angle = [0.0, 1.5708, 18]
    recorders = {
        f"{node_name}-lost": {
            "node": node_name,
            "event": "lost",
            "histograms": {"wavelength": list(wavelength)},
        },
    }
    if "box" in node_spec:
        size = [float(v) for v in node_spec["box"]["size"]]
        half = [s / 2.0 for s in size]
        axes = "xyz"
        faces = [
            ("top", [0, 0, 1]),
            ("bottom", [0, 0, -1]),
            ("east", [1, 0, 0]),
            ("west", [-1, 0, 0]),
            ("north", [0, 1, 0]),
            ("south", [0, -1, 0]),
        ]
        for label, facet in faces:
            axis = [i for i, v in enumerate(facet) if v != 0][0]
            u_axis, v_axis = [i for i in range(3) if i != axis]
            bins_u = max(10, min(60, int(size[u_axis] * 10)))
            bins_v = max(10, min(60, int(size[v_axis] * 10)))
            recorders[f"{node_name}-{label}"] = {
                "node": node_name,
                "event": "escaping",
                "facet": facet,
                "histograms": {
                    "wavelength": list(wavelength),
                    "angle": list(angle),
                    "position": [
                        axes[u_axis],
                        axes[v_axis],
                        [-half[u_axis], half[u_axis], bins_u],
                        [-half[v_axis], half[v_axis], bins_v],
                    ],
                },
            }
    else:
        recorders[f"{node_name}-escaping"] = {
            "node": node_name,
            "event": "escaping",
            "histograms": {
                "wavelength": list(wavelength),
                "angle": list(angle),
            },
        }
    return recorders


def parse_recorders(recorders_spec: dict, nodes: dict):
    """Build Recorder objects and attach them to their nodes."""
    for name, spec in recorders_spec.items():
        node_name = spec["node"]
        if node_name not in nodes:
            raise ValueError(f"Recorder {name!r}: unknown node {node_name!r}")
        histograms = []
        for prop, values in (spec.get("histograms") or {}).items():
            if prop == "position":
                prop_a, prop_b, range_a, range_b = values
                histograms.append(Heatmap(prop_a, prop_b, range_a, range_b))
            else:
                start, stop, bins = values
                histograms.append(Histogram(prop, start, stop, bins))
        recorder = Recorder(
            name,
            event=spec["event"],
            facet=spec.get("facet"),
            atol=spec.get("atol", 1e-6),
            histograms=histograms,
        )
        nodes[node_name].recorders.append(recorder)
