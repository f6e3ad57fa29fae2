"""The port stands alone and runs on the card unless told otherwise.

* No file of ``src/repro_torch`` — nor ``chip_smoke.py`` — imports ``jax``
  or ``repro`` (an AST scan of every import statement), and importing the
  port's modules, the ingestion, guarded serving and sharded paths' and
  the chain lint included, loads neither.
* ``build_session`` without a device targets ``cuda``; with no card it
  raises instead of running on the CPU.
* The ``gpu`` marker is registered in ``pyproject.toml``.
"""

import ast
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import paper_filters  # noqa: E402
from repro_torch.core import FilterPlan  # noqa: E402
from repro_torch.core import session as session_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            mods.add(str(node.args[0].value))
    return mods


def is_forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "session.py", "filter_chain.py", "ops.py",
            "tokenizer.py", "tokenize_cases.py", "pipeline.py",
            "ckpt.py", "guard.py", "fault_tolerance.py", "server.py",
            "traffic.py", "metrics.py", "serve.py", "sharded.py",
            "chain_lint.py", "diagnostics.py", "np_exec.py",
            "numpy_engine.py"} <= names
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(m for m in imported_modules(path) if is_forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PORT_MODULES = ["repro_torch", "repro_torch.core", "repro_torch.data",
                "repro_torch.data.tokenizer", "repro_torch.data.pipeline",
                "repro_torch.checkpoint", "repro_torch.configs.paper_filters",
                "repro_torch.kernels.filter_chain.ops", "repro_torch.runtime",
                "repro_torch.serving", "repro_torch.launch.serve",
                "repro_torch.core.sharded", "repro_torch.analysis"]


def test_importing_the_port_loads_no_jax_or_repro():
    """In a fresh interpreter, each module is imported first, with the
    port unloaded before it (an import cycle between ``core`` and ``data``
    shows this way); neither package is ever loaded."""
    code = ("import importlib, sys\n"
            "for mod in sys.argv[1:]:\n"
            "    for m in [m for m in sys.modules\n"
            "              if m.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[m]\n"
            "    importlib.import_module(mod)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    done = subprocess.run(
        [sys.executable, "-c", code, *PORT_MODULES], capture_output=True,
        text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src")})
    assert done.returncode == 0, done.stderr[-2000:]


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import plan\n"
                 "import importlib\nimportlib.import_module('repro.data')\n"
                 "from repro_torch.core import plan as ok\n")
    assert sorted(m for m in imported_modules(f) if is_forbidden(m)) == [
        "jax.numpy", "repro.core", "repro.data"]


def _plan():
    return FilterPlan(paper_filters.filter_chain("cnf"))


def test_build_session_defaults_to_cuda(monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, plan, device):
            seen["device"] = device

    monkeypatch.setattr(session_lib.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(session_lib, "FilterSession", Recorder)
    session_lib.build_session(_plan())
    assert seen["device"] == torch.device("cuda")


def test_build_session_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(session_lib.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session_lib.build_session(_plan())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session_lib.build_session(_plan(), device="cuda")
    assert session_lib.build_session(_plan(), device="cpu").device.type \
        == "cpu"


def test_gpu_marker_is_registered():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    markers = cfg["tool"]["pytest"]["ini_options"]["markers"]
    assert any(m.split(":")[0].strip() == "gpu" for m in markers)
