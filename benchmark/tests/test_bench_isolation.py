"""Nothing the benchmark runs loads JAX or the JAX package: the check that a
run makes on ``sys.modules`` (by whole top-level name, so the port,
``tts_max_tpu_torch``, passes), the same check in a fresh interpreter that
imports everything a run imports, and a scan of the reference's imports
(plain torch and numpy, nothing of the program)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_loaded({"jax.numpy", "numpy"}) == ["jax"]
    assert harness.forbidden_loaded({"jaxlib.xla_client", "flax.linen"}) == ["flax", "jaxlib"]
    assert harness.forbidden_loaded({"tts_max_tpu.ops.attention"}) == ["tts_max_tpu"]
    assert harness.forbidden_loaded({"tts_max_tpu_torch.inference.engine", "jaxtyping",
                                     "tts_max_tpu_torchx"}) == []


def test_a_run_imports_no_jax():
    """Every module a run of either loop loads, in a fresh interpreter."""
    code = (
        "import sys\n"
        "from benchmark import harness\n"
        "harness.set_cache_dirs()\n"
        "import benchmark.run, benchmark.calibrate, benchmark.trace\n"
        "from benchmark.loops import serve, train\n"
        "serve.greedy_params()\n"
        "from tts_max_tpu_torch.tools import serve_batch\n"
        "from tts_max_tpu_torch.data.collate import collate\n"
        "from tts_max_tpu_torch.training import optim, train_step\n"
        "for name in ['step_ms.serve', 'mfu.serve', 'ragged_decode_roofline.serve']:\n"
        "    harness.load_metric(name)\n"
        "print(harness.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("loads_flax", [False, True])
def test_a_reader_that_loads_jax_leaves_no_result(loads_flax):
    """The look at ``sys.modules`` comes after the per-layer readers and the
    trace's reduction are loaded: a reader that loads a forbidden module
    (here by putting it into ``sys.modules``, as an import does) leaves the
    run with no result and an exit code other than 0."""
    code = (
        "import json, sys, types\n"
        "from benchmark import harness, run\n"
        "class Reader:\n"
        "    def read(self, obs):\n"
        f"        if {loads_flax}:\n"
        "            sys.modules['flax'] = types.ModuleType('flax')\n"
        "        return 1.0\n"
        "harness.load_metric = lambda name: Reader()\n"
        "out = {'obs': {}, 'e2e': {}, 't_open': 0.0, 'attempted': 1, 'failed': 0,\n"
        "       'checks': [{'name': 'gap', 'value': 0.0, 'limit': 1.0, 'op': '<='}]}\n"
        "rc, result = run.finish(harness.benchmark_spec(), 'smollm2-1.7b.clone64', True, out, {})\n"
        "print(json.dumps([rc, result]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rc, result = json.loads(out.stdout.strip().splitlines()[-1])
    if loads_flax:
        assert rc != 0 and result is None and "flax" in out.stderr
    else:
        assert rc == 0 and result["correct"] and "step_ms.serve" in result["metrics"]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_plain_torch_only():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "statistics", "numpy", "torch"}, path


def test_no_benchmark_file_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN_MODULES), path
