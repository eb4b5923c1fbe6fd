"""The port stands alone: no module of vtm_tpu_torch/, and not
chip_smoke.py, imports jax or the reference package vtm_tpu, at the top of
a module or inside a function.  (The subprocess tests of the decode, encode
and parallel test files run the port with both made unimportable.)"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "vtm_tpu")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "vtm_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_roots(path):
    """(line, top-level package) of every import statement in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module.split(".")[0]))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args and isinstance(node.args[0], ast.Constant)):
            found.append((node.lineno, str(node.args[0].value).split(".")[0]))
    return found


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_native_modules_have_names_of_their_own():
    """The port's C extensions never take the reference's module names, so
    a process with both packages cannot load the reference's engine."""
    src = os.path.join(ROOT, "vtm_tpu_torch", "native")
    for name in ("cabac", "tcq", "depquant"):
        with open(os.path.join(src, f"{name}.c")) as f:
            text = f.read()
        assert f"PyInit__vtm_torch_{name}" in text
        assert f"_{name}_native" not in text
