"""The port's ``tokenizer.json`` reader (``tts_max_tpu_torch/core/hf_tokenizer.py``,
``core/tokenization.build_tokenizer``) against the JAX package's
``build_tokenizer`` (``transformers.AutoTokenizer`` plus ``extend_tokenizer``)
on ``tests/fixtures/llama3_style_tokenizer`` (a byte-level BPE built as
Llama 3's is, by ``tests/fixtures/make_llama3_style_tokenizer.py``): ids
identical on a fixed battery and a bounded hypothesis fuzz, with and
without special tokens, before and after the speech vocabulary is added;
the same length, ids of every added token, speech vocab, pad id and
decodes. Variants of the file that set ``lstrip``/``rstrip``/
``single_word``, ``add_prefix_space``, GPT-2's ``ByteLevel`` regex or no
``ignore_merges`` are held to the ``tokenizers`` package itself; files of
another kind raise."""

import copy
import json
import os
import random
import shutil

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu_torch.core import tokenization as ptok
from tts_max_tpu_torch.core.hf_tokenizer import HFTokenizer, split_pretokens

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "llama3_style_tokenizer")

BATTERY = [
    "",
    "Hello world",
    "I'M sure You'Re right, WE'LL see; they'd've said 'S 'T 'D 'ſ.",
    "don't can't won't it's we've",
    "digits 1234567 and 3.14159 and 0001 and 12,345,678",
    "   leading, trailing   ",
    "word  \n  next\n",
    "ends in spaces   ",
    "tabs\tand\t\ttabs\r\nCRLF\r\n\r\nand\rCR",
    "file\x1cgroup\x1drecord\x1eunit\x1f sep",
    "no\xa0break　ideographic line​zero",
    "今日はいい天気ですね。中文，标点！",
    "emoji \U0001f600\U0001f469‍\U0001f469 flags \U0001f1eb\U0001f1f7",
    "combining é ä ñ and ①² Ⅷ",
    "punct!!! ??? ... --- ((()))",
    "<|s_0|><|s_65535|>",
    "<|text_prompt_start|>Hello there<|text_prompt_end|><|speech_start|>"
    "<|s_0|><|s_65535|><|s_12|><|speech_end|>",
    "<|voice_description_start|>a calm voice<|voice_description_end|>"
    "<|sound_effect_start|>rain<|sound_effect_end|>",
    "<|begin_of_text|>typed specials<|eot_id|> and <|start_header_id|>user"
    "<|end_header_id|>\n\nhi<|eot_id|>",
    "broken <|s_1 and <|s_x|> and <|<|s_3|>|>",
    "x<|extra_token_3|>y<|s_100|>z <|extra_token_126000|>",
]


@pytest.fixture(scope="module")
def toks():
    ref = jtok.build_tokenizer(FIXTURE, max_seq_len=2048)
    mine = ptok.build_tokenizer(FIXTURE, max_seq_len=2048)
    return ref, mine


@pytest.fixture(scope="module")
def base_toks():
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(FIXTURE), HFTokenizer.from_dir(FIXTURE)


@pytest.mark.parametrize("special", [True, False])
def test_battery_ids_equal_transformers(toks, base_toks, special):
    for ref, mine in (toks, base_toks):
        for s in BATTERY:
            assert mine.encode(s, add_special_tokens=special) == \
                ref.encode(s, add_special_tokens=special), repr(s)
        assert mine(BATTERY[1])["input_ids"] == ref(BATTERY[1])["input_ids"]


def test_golden_ids_and_vocab(toks):
    ref, mine = toks
    with open(os.path.join(FIXTURE, "golden.json")) as f:
        golden = json.load(f)
    assert len(mine) == len(ref) == golden["vocab_size"] == 193856
    assert mine.pad_token_id == ref.pad_token_id == golden["pad_token_id"]
    assert mine.eos_token_id == ref.eos_token_id and mine.bos_token_id == ref.bos_token_id
    for s, ids in golden["ids"].items():
        assert mine.encode(s, add_special_tokens=True) == ids, s


def test_every_added_token_and_speech_vocab(toks):
    ref, mine = toks
    added = (ptok.extension_tokens() + [f"<|extra_token_{i}|>" for i in range(128000)]
             + ["<|eot_id|>", "<|begin_of_text|>", "<|python_tag|>", "not a token"])
    assert mine.convert_tokens_to_ids(added) == ref.convert_tokens_to_ids(added)
    a, b = jtok.speech_vocab(ref), ptok.speech_vocab(mine)
    assert np.array_equal(a.speech_to_token, b.speech_to_token)
    assert np.array_equal(a.token_to_speech, b.token_to_speech)
    assert a.generation_window() == b.generation_window()


@pytest.mark.parametrize("skip", [True, False])
def test_decode_equals_transformers(toks, skip):
    ref, mine = toks
    for s in BATTERY:
        ids = ref.encode(s, add_special_tokens=True)
        assert mine.decode(ids, skip_special_tokens=skip) == \
            ref.decode(ids, skip_special_tokens=skip), repr(s)
    ids = list(range(0, 193856, 997))
    assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)


_PIECES = ["a", "Z", "é", "ſ", "s", "'", "re", "LL", " ", "  ", "\t", "\n", "\r\n", "\x1c",
           "\xa0", "　", " ", "0", "123", "4567", "²", "Ⅷ", "٣", "今", "日本",
           "\U0001f600", "́", "‍", ".", "!?", "-", "_", "<", "|>", "<|", "<|s_7|>",
           "<|s_65535|>", "<|speech_end|>", "<|eot_id|>", "<|begin_of_text|>",
           "<|extra_token_9|>"]


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.one_of(st.sampled_from(_PIECES), st.characters(codec="utf-8")),
                max_size=16))
def test_fuzz_ids_equal_transformers(toks, base_toks, parts):
    s = "".join(parts)
    for ref, mine in (toks, base_toks):
        for special in (True, False):
            assert mine.encode(s, add_special_tokens=special) == \
                ref.encode(s, add_special_tokens=special), repr(s)


def _variants():
    with open(os.path.join(FIXTURE, "tokenizer.json")) as f:
        spec = json.load(f)
    flags = copy.deepcopy(spec)
    for t in flags["added_tokens"]:
        t["lstrip"] = t["content"] in ("<|eot_id|>", "<|end_of_text|>")
        t["rstrip"] = t["content"] in ("<|eom_id|>", "<|end_of_text|>")
        t["single_word"] = t["content"] == "<|python_tag|>"
    prefix = copy.deepcopy(spec)
    prefix["pre_tokenizer"]["pretokenizers"][1]["add_prefix_space"] = True
    gpt2 = copy.deepcopy(spec)
    gpt2["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False,
                             "trim_offsets": True, "use_regex": True}
    gpt2_prefix = copy.deepcopy(gpt2)
    gpt2_prefix["pre_tokenizer"]["add_prefix_space"] = True
    merges = copy.deepcopy(spec)
    merges["model"]["ignore_merges"] = False
    return {"flags": flags, "prefix": prefix, "gpt2": gpt2, "gpt2_prefix": gpt2_prefix,
            "merges": merges}


@pytest.mark.parametrize("name", ["flags", "prefix", "gpt2", "gpt2_prefix", "merges"])
def test_variants_equal_tokenizers(name):
    from tokenizers import Tokenizer

    spec = _variants()[name]
    ref = Tokenizer.from_str(json.dumps(spec))
    mine = HFTokenizer(spec)
    extra = ["<|s_5|>", "<|s_55|>", "<|speech_end|>", "<laugh>"]
    assert ref.add_tokens(extra) == mine.add_tokens(extra)
    assert len(mine) == ref.get_vocab_size(with_added_tokens=True)
    alpha = list("aAsStTrReEvVlL 'x_é́今0123.!?\t\n\r\x1c\xa0\U0001f600") + [
        "<|eot_id|>", "<|eom_id|>", "<|python_tag|>", "<|end_of_text|>", "<laugh>",
        "<|s_5|>", "<|s_55|>", "<|s_5", "  ", "the quick brown fox"]
    rng = random.Random(name)
    for _ in range(400):
        s = "".join(rng.choice(alpha) for _ in range(rng.randint(0, 12)))
        for special in (True, False):
            want = ref.encode(s, add_special_tokens=special).ids
            assert mine.encode(s, add_special_tokens=special) == want, repr(s)
        assert mine.decode(want) == ref.decode(want, skip_special_tokens=False)


def test_pretokenizer_scanners_equal_the_regex_engine():
    from tokenizers import Regex, pre_tokenizers

    from tts_max_tpu_torch.core.hf_tokenizer import LLAMA3_PATTERN

    gpt2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
    refs = {"llama3": pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated"),
            "gpt2": pre_tokenizers.Split(Regex(gpt2), "isolated")}
    # every code point of the White_Space set, of str.isspace's and of
    # Unicode 16's new letters and numbers, between letters and digits
    cps = [*range(0x9, 0x21), 0x85, 0xA0, 0x1680, *range(0x2000, 0x200E), 0x2028, 0x2029,
           0x202F, 0x205F, 0x3000, 0x1C89, 0xA7CB, 0x105C0, 0x10D40, 0x116D0, 0x17F, 0x212A]
    for pat, ref in refs.items():
        for cp in cps:
            for s in (f"a{chr(cp)}b", f"1{chr(cp)}2", f"{chr(cp)}{chr(cp)}x", f"'{chr(cp)}"):
                assert split_pretokens(s, pat) == [p for p, _ in ref.pre_tokenize_str(s)], \
                    (pat, hex(cp))


def _write(tmp_path, spec):
    d = tmp_path / "tok"
    d.mkdir(exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec))
    shutil.copy(os.path.join(FIXTURE, "tokenizer_config.json"), d)
    return str(d)


def test_unsupported_tokenizer_json_raises(tmp_path):
    with open(os.path.join(FIXTURE, "tokenizer.json")) as f:
        spec = json.load(f)
    llama2 = copy.deepcopy(spec)  # SentencePiece-style: Metaspace, byte fallback
    llama2["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"}, {"type": "Replace", "pattern":
                                                   {"String": " "}, "content": "▁"}]}
    llama2["pre_tokenizer"] = None
    llama2["model"]["byte_fallback"] = True
    with pytest.raises(ValueError, match="normalizer"):
        ptok.build_tokenizer(_write(tmp_path, llama2))
    llama2["normalizer"] = None
    with pytest.raises(ValueError, match="pre_tokenizer"):
        ptok.build_tokenizer(_write(tmp_path, llama2))
    other_regex = copy.deepcopy(spec)
    other_regex["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = r"\w+|\s+"
    with pytest.raises(ValueError, match="pre_tokenizer"):
        ptok.build_tokenizer(_write(tmp_path, other_regex))
    unigram = copy.deepcopy(spec)
    unigram["model"] = {"type": "Unigram", "vocab": [["a", 0.0]]}
    with pytest.raises(ValueError, match="model"):
        ptok.build_tokenizer(_write(tmp_path, unigram))
    fallback = copy.deepcopy(spec)
    fallback["model"]["byte_fallback"] = True
    with pytest.raises(ValueError, match="byte_fallback"):
        ptok.build_tokenizer(_write(tmp_path, fallback))
    with pytest.raises(FileNotFoundError):
        ptok.build_tokenizer(str(tmp_path / "empty"))
