"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, and no file of it (or chip_smoke.py) imports them."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|avir_tpu)\b", re.M)


def test_import_loads_no_jax():
    code = (
        "import sys, avir_tpu_torch, avir_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'avir_tpu' or "
        "m.startswith('avir_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "avir_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = _FORBIDDEN.findall(path.read_text())
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_api_modules_load_no_jax():
    """The modules of the public API beyond resize (batch staging, native
    binding, plan cache, timing helpers, metrology, CLI) load neither JAX
    nor the JAX package."""
    code = (
        "import sys\n"
        "import avir_tpu_torch.cli, avir_tpu_torch.metrology\n"
        "import avir_tpu_torch.native, avir_tpu_torch.plan.cache\n"
        "import avir_tpu_torch.utils.benchmarking, avir_tpu_torch.models.batch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'avir_tpu' or "
        "m.startswith('avir_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_all_covers_the_jax_package_all():
    """Every public name of the JAX package is a public name of the port."""
    import avir_tpu

    import avir_tpu_torch

    assert set(avir_tpu.__all__) <= set(avir_tpu_torch.__all__)


def test_star_import_binds_metrology_and_native():
    ns = {}
    exec("from avir_tpu_torch import *", ns)
    import avir_tpu_torch

    assert ns["metrology"] is avir_tpu_torch.metrology
    assert ns["native"] is avir_tpu_torch.native
