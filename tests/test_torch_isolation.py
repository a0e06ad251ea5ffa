"""The port stands alone: it imports no JAX and nothing of ``tts_max_tpu``."""

import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "tts_max_tpu_torch"
# `tts_max_tpu` as a whole module name: `tts_max_tpu_torch` must not match
_JAX_PKG = r"tts_max_tpu(?![\w])"
_IMPORT = re.compile(
    rf"^\s*(?:import\s+(?:jax\b|{_JAX_PKG})|from\s+(?:jax\b|{_JAX_PKG})[\s.])",
    re.MULTILINE,
)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_regex_tells_the_packages_apart():
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("from tts_max_tpu.models import llama")
    assert _IMPORT.search("  from tts_max_tpu import native")
    assert not _IMPORT.search("from tts_max_tpu_torch.models import llama")
    assert not _IMPORT.search("import tts_max_tpu_torch.ops")
    assert not _IMPORT.search("from jaxtyping import Array")


def test_no_jax_or_reference_package_imports_in_sources():
    offenders = [
        f"{path.relative_to(PKG.parent)}: {m.group(0).strip()}"
        for path in sorted(PKG.rglob("*.py"))
        for m in _IMPORT.finditer(path.read_text())
    ]
    assert not offenders, offenders


def test_every_module_imports_without_jax():
    """In a fresh interpreter where ``import jax`` fails, every module of the
    port imports, and no ``tts_max_tpu`` module gets loaded."""
    mods = list(_modules())
    assert len(mods) > 20
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'tts_max_tpu'"
        " or m.startswith('tts_max_tpu.') or m == 'jax' and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
