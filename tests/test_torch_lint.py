"""The port stands alone: ``src/repro_torch`` lints clean under edgelint with
no suppressions, and neither it nor ``chip_smoke.py`` imports JAX or the
JAX package, by AST and by importing every module with both blocked."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from tools.edgelint import lint_paths  # noqa: E402

PORT = REPO_ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]


def test_port_lints_clean_unsuppressed():
    res = lint_paths(["src/repro_torch", "chip_smoke.py"], root=REPO_ROOT)
    assert res.errors == []
    assert res.findings == [], "\n".join(f.render() for f in res.findings)
    assert res.suppressed == [], [s.render() for s in res.suppressed]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    # a relative import may climb at most to the repro_torch package itself
    depth = len(path.relative_to(PORT).parts) if PORT in path.parents else 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        elif isinstance(node, ast.ImportFrom):
            assert node.level <= depth, f"{path}:{node.lineno} imports outside repro_torch"
            continue
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        assert not bad, f"{path}:{node.lineno} imports {sorted(bad)}"


def test_every_module_imports_with_jax_and_reference_blocked():
    modules = [
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import sys, importlib\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": f"{REPO_ROOT / 'src'}:{REPO_ROOT}", "PATH": "/usr/bin:/bin"},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
