"""Write a Whisper-shaped tokenizer directory in pure Python (no
``tokenizers`` or ``transformers`` needed), for the port's Whisper
tokenizer reader (``tts_max_tpu_torch/training/rlhf/asr.WhisperTokenizer``).

The layout is Whisper large-v3's: a byte-level BPE (the 256-symbol byte
alphabet in GPT-2's order, then ``n_merges`` merges drawn from a seeded
``random.Random``, each joining two tokens already in the vocab), then
``<|endoftext|>``, ``<|startoftranscript|>``, the language tokens,
``<|translate|>``, ``<|transcribe|>``, ``<|startoflm|>``,
``<|startofprev|>``, ``<|nospeech|>``, ``<|notimestamps|>`` (all special)
and the timestamps ``<|0.00|>``, ``<|0.02|>``, ... (added, not special).
With the defaults (50001 merges, 100 languages, 1501 timestamps) the ids
are large-v3's: ``<|endoftext|>`` 50257, ``<|startoftranscript|>`` 50258,
the languages 50259-50358, ``<|transcribe|>`` 50360, ``<|notimestamps|>``
50364, the timestamps 50365-51865, 51866 ids in all.

The files are those a Whisper checkpoint carries: ``tokenizer.json`` (GPT-2's
``ByteLevel`` pre-tokenizer and decoder, the added tokens, a
``TemplateProcessing`` post-processor), ``vocab.json`` and ``merges.txt``
(what ``transformers.WhisperTokenizer`` reads), ``tokenizer_config.json``
(``added_tokens_decoder``, ``additional_special_tokens``, the
bos/eos/unk/pad tokens) and ``special_tokens_map.json``.

    python tests/fixtures/make_whisper_style_tokenizer.py [--full OUT_DIR]

writes the small committed fixture ``tests/fixtures/whisper_style_tokenizer/``
(300 merges, 5 languages, 51 timestamps), or the full-size directory.
"""

from __future__ import annotations

import argparse
import json
import os
import random

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "whisper_style_tokenizer")

# Whisper's 100 language codes, in the order of its token ids
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta "
    "no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk "
    "sq sw gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb "
    "my bo tl mg as tt haw ln ha ba jw su yue").split()
TASKS = ("<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
         "<|nospeech|>", "<|notimestamps|>")
EOT, SOT = "<|endoftext|>", "<|startoftranscript|>"


def bytes_to_unicode() -> list[str]:
    """GPT-2's printable alphabet for the 256 bytes, in its id order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs]


def build(n_merges: int = 50001, n_languages: int = 100, n_timestamps: int = 1501,
          seed: int = 0):
    """(vocab {token: id}, merges [(a, b)], specials [token], timestamps
    [token]); the specials and timestamps take the ids after the vocab,
    ``<|endoftext|>`` being the vocab's last id."""
    rng = random.Random(seed)
    tokens = bytes_to_unicode()
    vocab = {t: i for i, t in enumerate(tokens)}
    merges = []
    while len(merges) < n_merges:
        # favour short tokens, so that merges grow words a piece at a time
        a = tokens[min(rng.randrange(len(tokens)), rng.randrange(len(tokens)))]
        b = tokens[min(rng.randrange(len(tokens)), rng.randrange(len(tokens)))]
        if len(a) + len(b) > 10 or a + b in vocab:
            continue
        merges.append((a, b))
        vocab[a + b] = len(tokens)
        tokens.append(a + b)
    vocab[EOT] = len(tokens)
    specials = [EOT, SOT] + [f"<|{c}|>" for c in LANGUAGES[:n_languages]] + list(TASKS)
    stamps = ["<|%.2f|>" % (i * 0.02) for i in range(n_timestamps)]
    return vocab, merges, specials, stamps


def write(out_dir: str, n_merges: int = 50001, n_languages: int = 100,
          n_timestamps: int = 1501, seed: int = 0) -> int:
    """Write the directory; returns the number of ids."""
    vocab, merges, specials, stamps = build(n_merges, n_languages, n_timestamps, seed)
    os.makedirs(out_dir, exist_ok=True)
    eot = vocab[EOT]
    ids = {t: eot + i for i, t in enumerate(specials)}
    ids.update({t: eot + len(specials) + i for i, t in enumerate(stamps)})

    def added(t, special):
        return {"id": ids[t], "content": t, "single_word": False, "lstrip": False,
                "rstrip": False, "normalized": False, "special": special}

    added_tokens = [added(t, True) for t in specials] + [added(t, False) for t in stamps]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added_tokens,
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                          "use_regex": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": SOT, "type_id": 0}},
                       {"SpecialToken": {"id": "<|notimestamps|>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": EOT, "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": SOT, "type_id": 0}},
                     {"SpecialToken": {"id": "<|notimestamps|>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": EOT, "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                               for t in (SOT, "<|notimestamps|>", EOT)}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
    }
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    config = {
        "added_tokens_decoder": {str(t["id"]): {k: t[k] for k in (
            "content", "lstrip", "normalized", "rstrip", "single_word", "special")}
            for t in added_tokens},
        "additional_special_tokens": specials,
        "bos_token": EOT, "eos_token": EOT, "pad_token": EOT, "unk_token": EOT,
        "clean_up_tokenization_spaces": True, "errors": "replace",
        "model_max_length": 1024, "tokenizer_class": "WhisperTokenizer",
    }
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=1)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w", encoding="utf-8") as f:
        json.dump({"additional_special_tokens": specials, "bos_token": EOT, "eos_token": EOT,
                   "pad_token": EOT, "unk_token": EOT}, f, indent=1)
    return eot + len(specials) + len(stamps)


def write_small(out_dir: str = OUT) -> int:
    """The committed fixture: 300 merges, 5 languages, 51 timestamps."""
    return write(out_dir, n_merges=300, n_languages=5, n_timestamps=51)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", default="", help="write the full-size directory here")
    args = ap.parse_args()
    if args.full:
        print(write(args.full), "ids in", args.full)
    else:
        print(write_small(), "ids in", OUT)
