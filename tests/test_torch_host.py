"""The port's own host layers: its copies of the JAX package's scene API,
compiler and recorder specs compile every scene to the same tables, and
the port imports nothing of JAX or of the JAX package."""
import ast
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene as jax_compile_scene  # noqa: E402
from pvtrace_tpu_torch import scenes  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene  # noqa: E402

PORT = Path(scenes.__file__).resolve().parent
SCENES = {
    "bench": scenes.lsc_slab,
    "mixed": scenes.mixed_scene,
    "recorders4": functools.partial(scenes.lsc_slab_recorders, 4),
    "recorders256": functools.partial(scenes.lsc_slab_recorders, 256),
    "heatmap_xyz": functools.partial(scenes.lsc_slab_heatmap, 200),
    "tetrahedron": scenes.tetrahedron,
}
# CompiledScene attributes that hold the scene's own objects, which are of
# each package's classes: compared through the names and tables derived
# from them instead.
SCENE_OBJECTS = ("scene", "nodes")


def _assert_same(ref, got, where):
    """`got` equals `ref`: arrays element for element (NaN equal to NaN),
    containers item for item, objects of same-named classes attribute for
    attribute, everything else by ==."""
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), where
        for key in ref:
            _assert_same(ref[key], got[key], f"{where}[{key!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (r, g) in enumerate(zip(ref, got)):
            _assert_same(r, g, f"{where}[{i}]")
    elif hasattr(ref, "__dict__") and not callable(ref):
        assert type(got).__name__ == type(ref).__name__, where
        _assert_same(vars(ref), vars(got), f"{where}.{type(ref).__name__}")
    else:
        assert got == ref or (got != got and ref != ref), (where, got, ref)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_matches_jax(name):
    ref = jax_compile_scene(SCENES[name](pvtrace_tpu))
    got = compile_scene(SCENES[name]())
    assert sorted(vars(got)) == sorted(vars(ref))
    for key, value in vars(ref).items():
        if key not in SCENE_OBJECTS:
            _assert_same(value, getattr(got, key), key)
    assert [n.name for n in got.nodes] == [n.name for n in ref.nodes]
    if name == "recorders256":
        assert got.n_recorders == 256 and got.total_bins == 256 * 50
    if name == "bench":
        assert got.cheb_spec is not None and len(got.cheb_icdf) == 1


def _port_modules():
    return sorted(
        "pvtrace_tpu_torch" + ".".join(("",) + path.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for path in PORT.rglob("*.py")
    )


@pytest.fixture(scope="module")
def modules_after_import():
    """sys.modules of a fresh interpreter that imported every module of
    the port."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=120, cwd=PORT.parent,
    )
    return out.stdout.split()


@pytest.mark.parametrize("banned", ["jax", "pvtrace_tpu"])
def test_import_leaves_jax_and_the_jax_package_out(modules_after_import, banned):
    assert "pvtrace_tpu_torch.kernels.check" in modules_after_import
    assert "pvtrace_tpu_torch.scenes" in modules_after_import
    stray = [m for m in modules_after_import if m == banned or m.startswith(banned + ".")]
    assert stray == []


@pytest.mark.parametrize("banned", ["jax", "pvtrace_tpu"])
def test_no_port_file_imports_it(banned):
    """No import statement anywhere in the port, function bodies
    included, names `banned` or a module under it."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [
                f"{path.relative_to(PORT)}:{node.lineno} {name}" for name in names
                if name == banned or name.startswith(banned + ".")
            ]
    assert found == []
