"""The port stands alone: it imports no JAX (nor ``optax`` or ``orbax``),
nothing of ``tts_max_tpu``, no ``transformers``, ``tokenizers``, ``regex``,
``safetensors``, ``onnx`` or ``onnxruntime`` (the card's machine has none
of them), and nothing of the repository's ``tools`` package (its CLIs are
JAX's; the port has its own in ``tts_max_tpu_torch/tools``); nor do the
scripts that drive it on the card (``chip_smoke.py``,
``bench_sft_ranks.py``, ``tools/profile_torch_synthesis.py``), nor the ranks
of its gloo tests (``tests/_torch_dist_worker.py``, ``tests/_torch_tp_worker.py``).
Nor does any of them name a path into the JAX package's C++ runtime (the
repo-root ``native/`` source or ``tts_max_tpu/native/libttsmax_native.so``):
the port builds and loads its own (``tts_max_tpu_torch/native``).

The port is complete: every module of the JAX package has a counterpart at
the same path, or one named in ``RENAMED``, or a reason in ``NOT_PORTED``;
and every ``pallas_call`` site of the JAX package is named in a
``replaces`` of ``chip_smoke.py``'s ``kernels`` rows, whose ``source`` is a
file of ``tts_max_tpu_torch/csrc``. Both are text scans: a new JAX module or
Pallas site fails them until the port follows."""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tts_max_tpu_torch"
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "bench_sft_ranks.py",
           ROOT / "tools" / "profile_torch_synthesis.py", ROOT / "tests" / "_torch_dist_worker.py",
           ROOT / "tests" / "_torch_tp_worker.py"]
# `tts_max_tpu` as a whole module name: `tts_max_tpu_torch` must not match
_JAX_PKG = r"tts_max_tpu(?![\w])"
_BLOCKED = (rf"(?:jax\b|optax\b|orbax\b|transformers\b|tokenizers\b|regex\b|safetensors\b"
            rf"|onnx\b|onnxruntime\b|tools\b|{_JAX_PKG})")
_IMPORT = re.compile(rf"^\s*(?:import\s+{_BLOCKED}|from\s+{_BLOCKED}[\s.])", re.MULTILINE)
# a path component `native` (but the port's own `tts_max_tpu_torch/native`), or
# the JAX package's library by name
_NATIVE_PATH = re.compile(r"(?<!tts_max_tpu_torch/)(?<!\w)native(?:/|$)|libttsmax_native\.so")
_NATIVE_INCLUDE = re.compile(r'^\s*#\s*include\s*[<"][^>"]*native/', re.MULTILINE)
JAX_PKG = ROOT / "tts_max_tpu"
# JAX modules whose port lies under another name (relative to each package)
RENAMED = {
    "ops/pallas_attention.py": ("ops/flash_attention.py",),
    "ops/pallas_decode.py": ("ops/flash_decode.py", "ops/ragged_decode.py"),
    "ops/pallas_act1d.py": ("ops/act1d.py",),
}
# JAX modules the port has no counterpart of, and why
NOT_PORTED = {
    "utils/platform.py": "JAX_PLATFORMS and the XLA compile cache: XLA only",
}


def _native_paths(source: str) -> list[str]:
    """The string constants outside docstrings (f-string parts included)
    that name a path into the JAX package's C++ runtime."""
    tree = ast.parse(source)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs and _NATIVE_PATH.search(n.value)]


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_regex_tells_the_packages_apart():
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("import optax")
    assert _IMPORT.search("    import orbax.checkpoint as ocp")
    assert _IMPORT.search("from tts_max_tpu.models import llama")
    assert _IMPORT.search("  from tts_max_tpu import native")
    assert not _IMPORT.search("from tts_max_tpu_torch.models import llama")
    assert not _IMPORT.search("import tts_max_tpu_torch.ops")
    assert not _IMPORT.search("from jaxtyping import Array")
    assert _IMPORT.search("    from transformers import SeamlessM4TFeatureExtractor")
    assert _IMPORT.search("import transformers")
    assert not _IMPORT.search("import transformers_stream_generator")
    assert _IMPORT.search("from safetensors.numpy import load_file")
    assert _IMPORT.search("    from tools.serving_inference import build_codec")
    assert _IMPORT.search("import tools.serve_batch")
    assert not _IMPORT.search("from tts_max_tpu_torch.tools import serve_batch")
    assert not _IMPORT.search("import toolsmith")
    assert _IMPORT.search("import regex")
    assert _IMPORT.search("    from tokenizers import Tokenizer")
    assert not _IMPORT.search("import re")
    assert not _IMPORT.search("import regex_lite")
    assert _IMPORT.search("import onnx")
    assert _IMPORT.search("    import onnxruntime as ort")
    assert _IMPORT.search("from onnx import helper")
    assert not _IMPORT.search("from tts_max_tpu_torch.utils import onnx_lite")
    assert not _IMPORT.search("import onnx_lite")


def test_native_path_scan_tells_the_runtimes_apart():
    jax_loader = (ROOT / "tts_max_tpu" / "native" / "__init__.py").read_text()
    assert _native_paths(jax_loader) == ["libttsmax_native.so", "native"]
    for path in ("native", "native/ttsmax_native.cc", "../../native/ttsmax_native.cc",
                 "tts_max_tpu/native/libttsmax_native.so", "libttsmax_native.so"):
        assert _native_paths(f"x = {path!r}\n") == [path]
        assert _native_paths(f"def f():\n    return f'{{x}}/{path}'\n")
    for path in ("tts_max_tpu_torch/native", "csrc/ttsmax_native.cc", "build/host",
                 "libttsmax_native-0123abcdef01.so", "native encode us", "nativeness"):
        assert _native_paths(f"x = {path!r}\n") == []
    assert _native_paths('"""Counterpart of tts_max_tpu/native."""\n') == []
    assert _NATIVE_INCLUDE.search('#include "../../native/ttsmax_native.cc"')
    assert not _NATIVE_INCLUDE.search("#include <unordered_map>")


def test_no_jax_or_reference_package_imports_in_sources():
    scanned = sorted(PKG.rglob("*.py")) + SCRIPTS
    assert {"serving_inference.py", "serve_batch.py", "serve_http.py", "data_vectorizer.py",
            "data_merger.py", "convert_checkpoint.py", "distill_draft.py",
            "quant_quality.py"} <= {p.name for p in scanned if p.parent == PKG / "tools"}
    assert {PKG / "models" / "lora.py", PKG / "training" / "distill.py",
            PKG / "inference" / "quality.py", PKG / "core" / "hf_tokenizer.py",
            PKG / "utils" / "profiling.py", PKG / "models" / "codec" / "discriminator.py",
            PKG / "models" / "codec" / "losses.py", PKG / "training" / "codec" / "gan.py",
            PKG / "training" / "codec" / "gan_loop.py",
            PKG / "training" / "codec" / "codec_data.py", PKG / "models" / "whisper.py",
            PKG / "models" / "wavlm.py", PKG / "utils" / "onnx_lite.py",
            PKG / "native" / "__init__.py", ROOT / "tests" / "_torch_dist_worker.py",
            ROOT / "tests" / "_torch_tp_worker.py"} | {
            PKG / "parallel" / f"{m}.py" for m in (
                "__init__", "collectives", "mesh", "multihost", "sharding", "tensor")} | {
            PKG / "training" / "rlhf" / f"{m}.py" for m in (
                "asr", "dataset", "dnsmos", "ecapa", "grpo", "main", "reward_utils",
                "rewards", "topology")} <= set(scanned)
    offenders = [
        f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
        for path in scanned
        for m in _IMPORT.finditer(path.read_text())
    ]
    assert not offenders, offenders
    native_paths = [f"{path.relative_to(ROOT)}: {s!r}" for path in scanned
                    for s in _native_paths(path.read_text())]
    sources = sorted((PKG / "csrc").iterdir())
    assert PKG / "csrc" / "ttsmax_native.cc" in sources
    native_paths += [f"{path.relative_to(ROOT)}: {m.group(0).strip()}" for path in sources
                     for m in _NATIVE_INCLUDE.finditer(path.read_text())]
    assert not native_paths, native_paths


def test_every_module_imports_without_jax():
    """In a fresh interpreter where ``import jax``, ``import transformers``,
    ``import tokenizers``, ``import regex``, ``import safetensors``,
    ``import onnx``, ``import onnxruntime`` and the repository's ``import
    tools`` fail, every
    module of the port and both scripts import, the byte tokenizer encodes
    a prompt and the reward an edit distance through the port's own C++
    library (built under ``build/host``; the JAX package's is not mapped),
    and no ``tts_max_tpu`` module gets loaded."""
    mods = list(_modules())
    assert len(mods) > 20
    scripts = [str(p) for p in SCRIPTS]
    code = (
        "import sys, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['tokenizers'] = None\n"
        "sys.modules['regex'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['onnx'] = None\n"
        "sys.modules['onnxruntime'] = None\n"
        "sys.modules['tools'] = None\n"
        "sys.path.insert(0, 'tests')  # the tp worker imports the dist worker\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for path in {scripts!r}:\n"
        "    spec = importlib.util.spec_from_file_location('script', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from tts_max_tpu_torch import native\n"
        "from tts_max_tpu_torch.core import prompting, tokenization\n"
        "from tts_max_tpu_torch.training.rlhf import reward_utils\n"
        "tok = tokenization.build_byte_tokenizer()\n"
        "prompt = prompting.compile_training_prompt('hi', list(range(0, 65536, 97)))\n"
        "native.reset_counts()\n"
        "ids = tok.encode(prompt, add_special_tokens=True)\n"
        "assert ids == tok.encode_plain(prompt, add_special_tokens=True) and len(ids) > 676\n"
        "assert reward_utils.edit_distance('a b c'.split(), 'a c'.split()) == 1\n"
        "assert native.counts() == {'encode': 1, 'levenshtein': 1}, native.counts()\n"
        "lib = native.get_lib()._name\n"
        "assert lib.startswith(str(native.BUILD_DIR)), lib\n"
        "assert 'libttsmax_native.so' not in open('/proc/self/maps').read()\n"
        "bad = [m for m in sys.modules if m == 'tts_max_tpu'"
        " or m.startswith('tts_max_tpu.')"
        " or m in ('jax', 'optax', 'orbax', 'transformers', 'tokenizers', 'regex',"
        " 'safetensors', 'onnx', 'onnxruntime', 'tools')"
        " and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _pallas_sites(root: pathlib.Path) -> list[str]:
    """``path:line`` of every ``pallas_call(...)`` call under ``root``."""
    sites = []
    for path in sorted(root.rglob("*.py")):
        for n in ast.walk(ast.parse(path.read_text())):
            if isinstance(n, ast.Call) and (
                    getattr(n.func, "attr", None) == "pallas_call"
                    or getattr(n.func, "id", None) == "pallas_call"):
                sites.append(f"{path.relative_to(root.parent).as_posix()}:{n.lineno}")
    return sites


def _kernel_rows(script: pathlib.Path) -> list[tuple[str, str]]:
    """(source, replaces) of each ``row(fn, source, replaces, numbers)`` in
    the script's ``kernels`` list; ``row`` puts the source, a file name,
    under ``tts_max_tpu_torch/csrc/``."""
    assert 'source=f"tts_max_tpu_torch/csrc/{source}"' in script.read_text()
    rows = []
    for n in ast.walk(ast.parse(script.read_text())):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.List)
                and any(getattr(t, "id", None) == "kernels" for t in n.targets)):
            for call in n.value.elts:
                assert isinstance(call, ast.Call) and call.func.id == "row", ast.dump(call)
                rows.append((call.args[1].value, call.args[2].value))
    return rows


def _unported(jax_root: pathlib.Path, port_root: pathlib.Path) -> list[str]:
    """The JAX package's modules with no counterpart in the port."""
    missing = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel in NOT_PORTED:
            continue
        if not all((port_root / r).is_file() for r in RENAMED.get(rel, (rel,))):
            missing.append(rel)
    return missing


def _uncovered(sites: list[str], rows: list[tuple[str, str]]) -> list[str]:
    """The Pallas sites that no kernel row replaces, and the rows' sources
    that are not files of the port's ``csrc``."""
    bad = [site for site in sites
           if not any(re.search(rf"{re.escape(site)}(?!\d)", rep) for _, rep in rows)]
    return bad + [src for src, _ in rows if not (PKG / "csrc" / src).is_file()]


def test_every_jax_module_has_a_port():
    assert _unported(JAX_PKG, PKG) == []
    for rel in NOT_PORTED:  # the exceptions stay true
        assert (JAX_PKG / rel).is_file() and not (PKG / rel).exists(), rel
    for rel in RENAMED:
        assert (JAX_PKG / rel).is_file() and not (PKG / rel).exists(), rel


def test_every_pallas_site_has_a_hand_written_kernel():
    sites = _pallas_sites(JAX_PKG)
    assert len(sites) >= 7, sites
    rows = _kernel_rows(ROOT / "chip_smoke.py")
    assert len(rows) >= len(sites)
    assert _uncovered(sites, rows) == []


def test_coverage_scans_fail_on_a_new_module_or_site(tmp_path):
    """A JAX module with no counterpart, and a Pallas site or a row source
    the kernel rows do not cover, are reported."""
    jax_root, port_root = tmp_path / "tts_max_tpu", tmp_path / "tts_max_tpu_torch"
    for rel in ("ops/attention.py", "ops/pallas_act1d.py", "ops/new_op.py",
                "utils/platform.py"):
        (jax_root / rel).parent.mkdir(parents=True, exist_ok=True)
        (jax_root / rel).write_text("from jax.experimental import pallas as pl\n\n\n"
                                    "y = pl.pallas_call(\n    f)(x)\n")
    for rel in ("ops/attention.py", "ops/act1d.py"):
        (port_root / rel).parent.mkdir(parents=True, exist_ok=True)
        (port_root / rel).write_text("")
    assert _unported(jax_root, port_root) == ["ops/new_op.py"]
    sites = _pallas_sites(jax_root)
    assert sites == [f"tts_max_tpu/{r}:4" for r in (
        "ops/attention.py", "ops/new_op.py", "ops/pallas_act1d.py", "utils/platform.py")]
    rows = [("act1d.cu", "tts_max_tpu/ops/attention.py:4"),
            ("act1d.cu", "tts_max_tpu/ops/pallas_act1d.py:41"),
            ("missing.cu", "tts_max_tpu/utils/platform.py:4")]
    assert _uncovered(sites, rows) == ["tts_max_tpu/ops/new_op.py:4",
                                       "tts_max_tpu/ops/pallas_act1d.py:4", "missing.cu"]
