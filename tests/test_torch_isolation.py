"""``repro_torch`` and ``chip_smoke.py`` must run without JAX: no module of
the port imports ``jax`` or anything of ``repro``."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "repro"))]
print(len(names), leaked)
"""


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, leaked = r.stdout.split(" ", 1)
    assert int(n) >= 20
    assert leaked.strip() == "[]"


def test_no_jax_or_repro_import_statements():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert len(files) > 20
    assert bad == []


_IMPORT_CKPT = """
import sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None      # importing any of them now raises
import repro_torch.checkpoint, repro_torch.resilience
import repro_torch.checkpoint.checkpoint, repro_torch.resilience.faults
import repro_torch.resilience.supervisor, repro_torch.resilience.backoff
leaked = [n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))]
print(leaked)
"""


def test_checkpoint_and_resilience_need_no_jax_or_ml_dtypes():
    """The checkpoint format keeps its own dtype table (bfloat16 included)
    and the resilience layer its own copies, so neither imports ``jax``,
    ``ml_dtypes`` or anything of ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_CKPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
    files = sorted((ROOT / "src" / "repro_torch" / "checkpoint").glob(
        "*.py")) + sorted((ROOT / "src" / "repro_torch" / "resilience"
                           ).glob("*.py"))
    assert len(files) == 6
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] == "ml_dtypes" or _forbidden(n)
                               for n in names), (path.name, node.lineno)
