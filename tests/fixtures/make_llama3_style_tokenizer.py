"""Write ``tests/fixtures/llama3_style_tokenizer/``: a small byte-level BPE
tokenizer built the way Llama 3's is, for the port's ``tokenizer.json``
reader (``tts_max_tpu_torch/core/tokenization.build_tokenizer``).

The BPE is trained here, offline, with the ``tokenizers`` package on a
seeded corpus of the sentences below, to at most 1000 ids (this corpus
gives 683: the 256-symbol byte alphabet and 427 merges). Everything around the model
is Llama 3's: the ``Split`` pre-tokenizer on Llama 3's regex followed by
``ByteLevel(add_prefix_space=False, use_regex=False)``, ``ignore_merges``,
the ``ByteLevel`` decoder, the post-processor ``ByteLevel`` +
``TemplateProcessing("<|begin_of_text|> $A")``, and a dozen of Llama 3's
special tokens appended after the BPE's ids. ``transformers`` saves it
(``tokenizer.json``, ``tokenizer_config.json`` with ``bos_token``
<|begin_of_text|> and ``eos_token`` <|eot_id|>, as the Instruct models
set them) and ``golden.json`` maps strings to the ids that
``transformers.AutoTokenizer`` gives them, extended with the speech
vocabulary to the fixed 193856 ids.

    python tests/fixtures/make_llama3_style_tokenizer.py

Needs ``tokenizers`` and ``transformers``; the port reads the files
without either.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "llama3_style_tokenizer")

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
            "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
            "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
            "<|eom_id|>", "<|eot_id|>", "<|python_tag|>", "<|reserved_special_token_3|>"]
VOCAB_SIZE = 1000

SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the riverbank.",
    "She sells sea shells by the sea shore, and I'm sure they're real.",
    "We'll meet at 10:30 on March 3rd, 2024; don't be late!",
    "Convert the text to speech: hello world, how are you today?",
    "A calm narrator with a low voice reads the news at 7 pm.",
    "It's 42 degrees outside—too hot for a walk, isn't it?",
    "Numbers like 1234567 and 3.14159 split into runs of three digits.",
    "Tabs\tand\nnew lines\r\nare whitespace too.",
    "Café, naïve, résumé and über carry accents.",
    "今日はいい天気ですね。",
    "Привет, как дела?",
    "Emoji \U0001f600 and symbols like © ™ €100.",
    "You've got mail; they'd said we'd go.",
    "Speech tokens such as <|s_0|> sit between <|speech_start|> and <|speech_end|>.",
]


def corpus(n: int = 4000):
    rng = np.random.default_rng(0)
    words = " ".join(SENTENCES).split()
    for _ in range(n):
        k = int(rng.integers(3, 12))
        yield " ".join(words[int(i)] for i in rng.integers(0, len(words), k))
    yield from SENTENCES


GOLDEN = [
    "Hello world",
    "The quick brown fox jumps over the lazy dog near the riverbank.",
    "I'M sure You'Re right, WE'LL see.",
    "  leading spaces, trailing spaces   ",
    "digits 1234567 and 3.14159",
    "tabs\tand\r\nnew lines\n\n",
    "今日は \U0001f600 café",
    "<|begin_of_text|>typed specials<|eot_id|>",
    "<|text_prompt_start|>Hello there<|text_prompt_end|><|speech_start|>"
    "<|s_0|><|s_65535|><|s_12|><|s_7|><|speech_end|>",
    "x<|extra_token_3|>y<|s_100|>z",
]


def main() -> int:
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import processors, trainers
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=VOCAB_SIZE, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus(), trainer)
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False) for s in SPECIALS])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            pair="<|begin_of_text|> $A <|begin_of_text|>:1 $B:1",
            special_tokens=[("<|begin_of_text|>", bos)]),
    ])
    spec = json.loads(tok.to_str())
    if not spec["model"].get("ignore_merges"):  # kept by the trainer; checked
        raise SystemExit("the trained BPE lost ignore_merges")

    os.makedirs(OUT, exist_ok=True)
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<|begin_of_text|>",
                                   eos_token="<|eot_id|>", model_max_length=131072,
                                   clean_up_tokenization_spaces=True)
    fast.save_pretrained(OUT)
    for extra in ("special_tokens_map.json",):
        path = os.path.join(OUT, extra)
        if os.path.exists(path):
            os.remove(path)

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from tts_max_tpu.core.tokenization import build_tokenizer

    hf = build_tokenizer(OUT, max_seq_len=2048)
    ids = ",\n".join(f"  {json.dumps(s, ensure_ascii=False)}: "
                     f"{json.dumps(hf.encode(s, add_special_tokens=True))}" for s in GOLDEN)
    with open(os.path.join(OUT, "golden.json"), "w") as f:
        f.write(f'{{"vocab_size": {len(hf)}, "pad_token_id": {hf.pad_token_id}, '
                f'"ids": {{\n{ids}}}}}\n')
    print(f"wrote {OUT}: {len(AutoTokenizer.from_pretrained(OUT))} base ids, "
          f"{len(hf)} extended")
    return 0


if __name__ == "__main__":
    sys.exit(main())
