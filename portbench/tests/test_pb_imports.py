"""Nothing the benchmark runs imports ``jax`` or the JAX package, and the
reference imports nothing of the port.  Module names are compared by
their top-level name, whole: ``avir_tpu_torch`` is not ``avir_tpu``."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "avir_tpu"}


def imported_top_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((spec.HERE / "reference").rglob("*.py")):
        names = imported_top_names(path)
        assert not names & (FORBIDDEN | {"avir_tpu_torch", "tests"}), path


def test_loaded_modules_after_a_rehearsal():
    """A CPU rehearsal of a cell leaves none of them in ``sys.modules``."""
    code = (
        "import sys, runpy; sys.argv = ['rehearse.py', '--workload', "
        "'avir_def_u8_rgb.photo_album_down', '--seconds', '0.2', '--scale', '32'];\n"
        "try:\n    runpy.run_path('portbench/rehearse.py', run_name='__main__')\n"
        "except SystemExit:\n    pass\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % FORBIDDEN
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=spec.REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
