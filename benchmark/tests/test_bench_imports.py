"""What a run may load: nothing of JAX or of the JAX package
(`slam1_tpu`), compared by whole top-level module names
(`slam1_tpu_torch` is the program), and the references nothing of the
program either. Each case imports in a fresh interpreter."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "slam1_tpu"}


def _modules_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {imports}; "
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _metric_imports() -> str:
    return "import runpy; " + "; ".join(
        f"runpy.run_path({str(p)!r})"
        for p in sorted((BENCH / "metrics").glob("*.py")))


def test_harness_and_program_load_no_jax():
    found = _modules_after(
        "import benchmark.harness.cli, benchmark.harness.slam, "
        "benchmark.harness.offline, benchmark.harness.readers; "
        "import slam1_tpu_torch.models.pipeline, slam1_tpu_torch.models.ba, "
        "slam1_tpu_torch.models.posegraph, slam1_tpu_torch.config, "
        "slam1_tpu_torch.ops.camera, slam1_tpu_torch.utils.graphs; "
        + _metric_imports())
    assert "slam1_tpu_torch" in found
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    found = _modules_after(
        "import benchmark.reference.ba_ref, "
        "benchmark.reference.slam_check, benchmark.yardstick.synth, "
        "benchmark.yardstick.bounds")
    assert not found & (FORBIDDEN | {"slam1_tpu_torch"})


@pytest.mark.parametrize("folder", ["reference", "yardstick"])
def test_reference_sources_name_no_program_module(folder):
    for path in (BENCH / folder).glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"slam1_tpu_torch"}, \
                    (path.name, n)


def test_run_without_the_program_fails_and_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ba-global-2048",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
