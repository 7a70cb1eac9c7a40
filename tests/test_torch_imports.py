"""The port stands alone: no module of ``llm_np_cp_tpu_torch``, no line
of ``chip_smoke.py`` or ``tools/mesh_phase.py``, and none of the spawned
ranks' bodies in ``tests/mesh_ranks.py`` imports JAX, the JAX package,
the repo's ``tools``, a package the machine with the card lacks, or the
JAX package's optimizer and checkpoint libraries (``optax``, ``orbax``)."""

import ast
import pathlib

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "llm_np_cp_tpu", "ml_dtypes", "safetensors", "transformers",
             "huggingface_hub", "triton", "tools", "optax", "orbax"}
FILES = sorted((ROOT / "llm_np_cp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "mesh_phase.py", ROOT / "tests" / "mesh_ranks.py"]


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
            "llm_np_cp_tpu_torch/serve/engine.py", "llm_np_cp_tpu_torch/serve/scheduler.py",
            "llm_np_cp_tpu_torch/random.py", "llm_np_cp_tpu_torch/ops/cuda/threefry.py",
            "llm_np_cp_tpu_torch/serve/host_tier.py", "llm_np_cp_tpu_torch/serve/http/server.py",
            "llm_np_cp_tpu_torch/serve/http/protocol.py", "llm_np_cp_tpu_torch/serve/faults.py",
            "llm_np_cp_tpu_torch/serve/journal.py", "llm_np_cp_tpu_torch/serve/request_log.py",
            "llm_np_cp_tpu_torch/utils/loading.py", "llm_np_cp_tpu_torch/serve/tracing.py",
            "llm_np_cp_tpu_torch/serve/slo.py", "llm_np_cp_tpu_torch/serve/telemetry.py",
            "llm_np_cp_tpu_torch/serve/otel.py", "llm_np_cp_tpu_torch/serve/tenants.py",
            "llm_np_cp_tpu_torch/serve/lifecycle.py", "llm_np_cp_tpu_torch/serve/replica.py",
            "llm_np_cp_tpu_torch/cli.py", "llm_np_cp_tpu_torch/backends/__init__.py",
            "llm_np_cp_tpu_torch/backends/numpy_ref.py", "llm_np_cp_tpu_torch/utils/profiling.py",
            "llm_np_cp_tpu_torch/ops/moe.py", "llm_np_cp_tpu_torch/parallel/sharding.py",
            "llm_np_cp_tpu_torch/parallel/collectives.py",
            "llm_np_cp_tpu_torch/parallel/ring_attention.py",
            "llm_np_cp_tpu_torch/parallel/launch.py", "tests/mesh_ranks.py",
            "llm_np_cp_tpu_torch/train.py", "llm_np_cp_tpu_torch/parallel/pipeline.py",
            "llm_np_cp_tpu_torch/utils/checkpoint.py", "chip_smoke.py"} <= names
    assert imported_roots(ROOT / "tests" / "test_torch_model.py") >= {"jax", "llm_np_cp_tpu"}
    assert "llm_np_cp_tpu_torch" in imported_roots(ROOT / "chip_smoke.py")


CUDA_SOURCES = sorted((ROOT / "llm_np_cp_tpu_torch" / "csrc").glob("*.cu*"))


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_sources_include_only_their_own_and_cuda_headers(path):
    """Kernel sources include system headers (<...>) and each other by
    bare name, nothing else (no path into the JAX package)."""
    local = {p.name for p in CUDA_SOURCES}
    for line in path.read_text().splitlines():
        if line.startswith("#include"):
            spec = line.split()[1]
            assert spec.startswith("<") or spec.strip('"') in local, spec


@pytest.mark.parametrize("path", [p for p in FILES if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_torch_generator_draws(path):
    """Model-path draws are keyed (``random``, jax's threefry bits): no
    module of the port draws from a ``torch.Generator``.  Only the seeded
    random weights of ``init_params`` use one."""
    text = path.read_text()
    allowed = path.name == "transformer.py" and text.count("torch.Generator(") == 1
    assert "torch.Generator" not in text or allowed, path
    assert "exponential_(" not in text and "torch.rand(" not in text, path
