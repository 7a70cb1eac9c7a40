"""The port stands alone: no module of ``llm_np_cp_tpu_torch`` and no line
of ``chip_smoke.py`` imports JAX, the JAX package, or a package the
machine with the card lacks."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "llm_np_cp_tpu", "ml_dtypes", "safetensors", "transformers",
             "huggingface_hub", "triton"}
FILES = sorted((ROOT / "llm_np_cp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: pathlib.Path) -> set[str]:
    """Top-level package of every import in the file (exact name)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_the_port():
    """The scan covers the whole package (and would catch a JAX import)."""
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"llm_np_cp_tpu_torch/generate.py", "llm_np_cp_tpu_torch/ops/cuda/build.py",
            "chip_smoke.py"} <= names
    assert imported_roots(ROOT / "tests" / "test_torch_model.py") >= {"jax", "llm_np_cp_tpu"}
    assert "llm_np_cp_tpu_torch" in imported_roots(ROOT / "chip_smoke.py")
