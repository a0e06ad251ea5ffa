"""The port's C++ host runtime (``tts_max_tpu_torch/native``,
``csrc/ttsmax_native.cc``) against its plain Python versions and the JAX
package's ``tts_max_tpu/native`` on the CPU.

- ``ByteTokenizer.encode`` (native) equals the port's ``encode_plain`` and
  the JAX package's Python path on training prompts, the texts of
  ``tests/test_native.py`` and a hypothesis strategy over ``<``, ``|``,
  ``>``, ``s``, ``_``, digits, ASCII and multi-byte UTF-8; it equals JAX's
  C++ path wherever that path has no fault;
- each form on which JAX's C++ path gives other ids than its Python path
  (leading zeros, digit runs that overflow int64, and two on vocabularies
  with tokens the default one lacks) gives the Python path's ids in the port;
- ``levenshtein`` equals JAX's and the plain edit distance, the empty
  sequences included; ``word_error_rate`` and ``char_error_rate`` equal
  JAX's;
- a compiler that is missing or fails raises, and nothing falls back to
  Python; processes building at once all load the library; the tokenizer
  is rebuilt after ``add_tokens``; the call counters count every call.
"""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tts_max_tpu import native as jnative
from tts_max_tpu.core import prompting as jprompting, tokenization as jtokenization
from tts_max_tpu.training.rlhf import reward_utils as jru
from tts_max_tpu_torch import native
from tts_max_tpu_torch.core import prompting, tokenization
from tts_max_tpu_torch.training.rlhf import reward_utils as ru

# tests/test_native.py's texts
NATIVE_TEXTS = [
    jprompting.compile_training_prompt("hello wörld", [0, 65535, 42]),
    "plain text, no specials",
    "<|speech_start|><|s_1|><|s_999|><|speech_end|>",
    "<|unknown_token|> stays bytes",
    "edge <| not closed",
    "<|s_99999999|> out of range",
    "日本語のテキスト<|s_5|>",
]
ALPHABET = "<|>s_0123456789 aZ~\né日😀"
FRAGMENTS = ["<|", "|>", "<|s_", "<|s_0|>", "<|s_7|>", "<|s_65535|>", "<|s_65536|>",
             "<|s_007|>", "<|speech_start|>", "<|eot_id|>", "<||>", "<|s_|>"]


@pytest.fixture(scope="module")
def tok():
    return tokenization.build_byte_tokenizer()


@pytest.fixture(scope="module")
def jtok():
    """The JAX tokenizer of the same vocabulary, and its C++ encoder. JAX's
    loader writes its library in place, so a worker that loads it while
    another still builds it finds none: wait for the build."""
    t = jtokenization.build_byte_tokenizer()
    deadline = time.monotonic() + 120
    while jnative.get_lib() is None:
        assert time.monotonic() < deadline, "the JAX package's native library did not build"
        time.sleep(0.5)
        jnative._LIB_TRIED = False
    t._native = None
    cpp = t._get_native()
    assert cpp is not None
    return t, cpp


def _jax_python(jt, text: str) -> list[int]:
    saved = jt._native
    jt._native = False  # JAX's pure-Python path (as tests/test_native.py takes it)
    try:
        return jt.encode(text)
    finally:
        jt._native = saved


def _jax_cpp(cpp, text: str) -> list[int]:
    out = cpp.encode(text)
    assert out is not None
    return out.tolist()


def _jax_cpp_fault(text: str) -> bool:
    """Whether ``text`` holds a "<|s_N|>" whose N JAX's C++ path reads other
    than as the added token: leading zeros, or 19 digits and more, which
    can wrap its int64."""
    import re

    return any((len(d) > 1 and d[0] == "0") or len(d) >= 19
               for d in re.findall(r"<\|s_(\d+)\|>", text))


def _prompts():
    """Training prompts on code 0, code 65535 and 1500 seeded codes (SFT's
    sample length), with and without a voice description, and inference
    prompts in both modes."""
    rng = np.random.default_rng(0)
    text = "A transcript, with wörds 日本"
    codes = rng.integers(0, 65536, 1500).tolist()
    out = [prompting.compile_training_prompt(text, c, d)
           for c in ([0], [65535], codes) for d in ("", "a calm voice")]
    out += [prompting.compile_inference_prompt(text, "Next line.", codes[:250], "", True),
            prompting.compile_inference_prompt("", "Next line.", [], "a bright voice", False)]
    assert out[4] == jprompting.compile_training_prompt(text, codes, "")
    return out


def _check(tok, jtok, text: str) -> None:
    jt, cpp = jtok
    ids = tok.encode(text)
    assert ids == tok.encode_plain(text), text
    assert ids == _jax_python(jt, text), text
    if not _jax_cpp_fault(text):
        assert ids == _jax_cpp(cpp, text), text
    assert tok.encode(text, add_special_tokens=True) == [1, *ids]


@pytest.mark.parametrize("which", ["prompts", "test_native"])
def test_encode_matches_plain_and_jax(tok, jtok, which):
    texts = _prompts() if which == "prompts" else NATIVE_TEXTS
    for text in texts:
        _check(tok, jtok, text)
    if which == "prompts":
        assert len(tok.encode(texts[4])) > 1500


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.one_of(st.sampled_from(FRAGMENTS), st.text(ALPHABET, max_size=6)),
                max_size=12))
def test_encode_matches_plain_and_jax_on_random_text(tok, jtok, parts):
    _check(tok, jtok, "".join(parts))


# text: (tokens added to the default vocabulary, the token JAX's C++ path
# reads there, the token its Python path reads; None: the text's bytes)
JAX_CPP_FAULTS = {
    "leading_zeros": ("<|s_007|>", [], "<|s_7|>", None),
    "thirty_one_zeros": ("<|s_" + "0" * 31 + "1|>", [], "<|s_1|>", None),
    "int64_overflow": ("<|s_18446744073709551617|>", [], "<|s_1|>", None),  # 2**64 + 1
    # JAX's C++ scans 64 bytes for the closing "|>"
    "token_over_64_bytes": ("<|" + "x" * 70 + "|>", ["<|" + "x" * 70 + "|>"], None,
                            "<|" + "x" * 70 + "|>"),
    # the regex body stops at '|'; JAX's C++ scan does not
    "bar_inside_a_token": ("<|a|b|>", ["<|a|b|>"], "<|a|b|>", None),
}


@pytest.mark.parametrize("form", sorted(JAX_CPP_FAULTS))
def test_jax_cpp_fault_forms_take_the_python_ids(form):
    """Each form gives other ids in JAX's C++ path than in its Python path
    (a Hugging Face tokenizer's rule: only the exact added token, and only
    where the regex ``<\\|[^|<>]+\\|>`` matches); the port gives the Python
    path's."""
    text, extra, cpp_token, python_token = JAX_CPP_FAULTS[form]
    t = tokenization.build_byte_tokenizer()
    jt = jtokenization.build_byte_tokenizer()
    t.add_tokens(extra)
    jt.add_tokens(extra)
    cpp = jt._get_native()
    assert cpp is not None

    def ids(token):
        return [3 + b for b in text.encode()] if token is None else [
            jt.convert_tokens_to_ids(token)]

    python_ids = _jax_python(jt, text)
    assert _jax_cpp(cpp, text) == ids(cpp_token) != python_ids == ids(python_token)
    assert t.encode(text) == t.encode_plain(text) == python_ids
    assert _jax_cpp_fault(text) == (not extra)


def test_tokenizer_is_rebuilt_after_add_tokens():
    t = tokenization.build_byte_tokenizer()
    text = "a <|brand_new|> b"
    before = t.encode(text)
    first = t._native
    assert first is not None
    assert t.add_tokens(["<|s_7|>"]) == 0  # nothing new: the encoder stays
    assert t._native is first
    assert t.add_tokens(["<|brand_new|>"]) == 1
    after = t.encode(text)
    assert t._native is not None and t._native is not first
    assert before == [3 + b for b in text.encode()]
    assert after == t.encode_plain(text) == [3 + ord("a"), 3 + ord(" "),
                                             t.convert_tokens_to_ids("<|brand_new|>"),
                                             3 + ord(" "), 3 + ord("b")]


def test_levenshtein_matches_jax_and_plain():
    rng = np.random.default_rng(0)
    pairs = [([], []), (["a"], []), ([], ["a", "b"]), (list("kitten"), list("sitting"))]
    for _ in range(200):
        vocab = rng.integers(1, 6)
        pairs.append(([str(x) for x in rng.integers(0, vocab, rng.integers(0, 40))],
                      [str(x) for x in rng.integers(0, vocab, rng.integers(0, 40))]))
    words = [f"w{i}" for i in range(30)]
    for n in (50, 200):
        ref = list(rng.choice(words, n))
        hyp = [w if rng.random() < 0.8 else str(rng.choice(words)) for w in ref if
               rng.random() < 0.95]
        pairs.append((ref, hyp))
    for ref, hyp in pairs:
        d = native.levenshtein(ref, hyp)
        assert d == jnative.levenshtein(ref, hyp) == ru.edit_distance_plain(ref, hyp)
        assert ru.edit_distance(ref, hyp) == d
        assert native.levenshtein(hyp, ref) == d


def test_error_rates_match_jax():
    rng = np.random.default_rng(1)
    texts = ["", "x", "the cat sat on the mat", "日本語のテキスト", "a b c d e"]
    texts += [" ".join(rng.choice(["a", "b", "c", "dé", "日"], rng.integers(1, 30)))
              for _ in range(40)]
    for a in texts:
        for b in texts[:8]:
            assert ru.word_error_rate(a, b) == jru.word_error_rate(a, b)
            assert ru.char_error_rate(a, b) == jru.char_error_rate(a, b)


def test_counters_count_every_call_across_threads(tok):
    native.reset_counts()
    text = prompting.compile_training_prompt("counted", list(range(100)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(50):
                tok.encode(text)
                ru.edit_distance(["a", "b"], ["b"])

        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert native.counts() == {"encode": 400, "levenshtein": 400}
    native.reset_counts()
    assert native.counts() == {"encode": 0, "levenshtein": 0}


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler-g"):
        native.get_lib()
    with pytest.raises(RuntimeError):
        tokenization.ByteTokenizer().encode("hi")
    with pytest.raises(RuntimeError):
        ru.edit_distance(["a"], ["b"])
    assert list(tmp_path.iterdir()) == []


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text('extern "C" int f( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error") as e:
        native.get_lib()
    assert "bad.cc" in str(e.value)
    assert [p.name for p in (tmp_path / "build").iterdir()] == []  # no temporary left


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes build into one empty directory at once: each writes
    its own temporary file and renames it, so every one loads a whole
    library and encodes."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from tts_max_tpu_torch import native\n"
        "from tts_max_tpu_torch.core import tokenization\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "t = tokenization.build_byte_tokenizer(codebook_size=16)\n"
        "assert t.encode('<|s_3|>x') == t.encode_plain('<|s_3|>x')\n"
        "print(native.get_lib()._name)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1 and names.pop().startswith(str(tmp_path))
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
