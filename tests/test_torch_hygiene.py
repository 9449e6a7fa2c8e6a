"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX, the reference package ``repro``, or
``ml_dtypes`` (the machine with the card does not have it; bfloat16
checkpoint leaves are stored as byte views without it)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_covers_the_package():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("part", ["checkpoint", "obs", "baselines",
                                  "configs/paper.py", "netsim",
                                  "core/mesh.py", "core/sharded_dmtl.py",
                                  "serving", "models/cache.py",
                                  "models/kvquant.py", "serve.py",
                                  "models/moe.py"])
def test_scan_covers_the_checkpointed_slice(part):
    target = ROOT / "src" / "repro_torch" / part
    files = [target] if target.suffix else sorted(target.glob("*.py"))
    assert files and all(f in FILES for f in files)
    assert target.suffix or target / "__init__.py" in files
