"""The traffic generators: the same seed gives the same requests and
batches, every seed the same set of sizes, the lengths lie in the stated
ranges, and the ids follow the port's prompt layout and tokenizer."""

import functools
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, traffic  # noqa: E402

SEEDS = (0, 2 ** 31 + 7, 12345678901)


def serve(name, seed):
    return traffic.ServeTraffic(harness.load_json("traffic", name), seed)


def collate_fn():
    from tts_max_tpu_torch.data.collate import collate

    return functools.partial(collate, pad_token_id=0, max_seq_len=2048)


@pytest.mark.parametrize("name", ["clone64"])
def test_serve_same_seed_same_requests(name):
    a, b = serve(name, SEEDS[1]), serve(name, SEEDS[1])
    for i in (0, 5, 63, 64, 200):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.budget, ra.greedy, ra.sampling_seed) == (rb.budget, rb.greedy, rb.sampling_seed)
    assert not np.array_equal(a.request(0).prompt, serve(name, SEEDS[2]).request(0).prompt)


@pytest.mark.parametrize("name", ["clone64"])
def test_serve_every_block_holds_the_same_sizes(name):
    mix = harness.load_json("traffic", name)
    out = mix["output"]
    sets = []
    for seed in SEEDS:
        t = serve(name, seed)
        for block in range(3):
            reqs = [t.request(block * t.block + j) for j in range(t.block)]
            budgets = sorted(r.budget for r in reqs)
            sets.append(budgets)
            assert out["min_tokens"] <= budgets[0] and budgets[-1] <= out["max_tokens"]
            assert sum(r.greedy for r in reqs) == t.block // mix["greedy_every"]
            lo, hi = t.prompt_range()
            assert all(lo <= len(r.prompt) <= hi for r in reqs)
    assert all(s == sets[0] for s in sets)
    assert sets[0][len(sets[0]) // 2 - 1] <= out["median_tokens"] <= sets[0][len(sets[0]) // 2]


def test_clone_voices_and_prompt_lengths():
    mix = harness.load_json("traffic", "clone64")
    t = serve("clone64", SEEDS[0])
    lens = sorted(len(codes) for codes, _ in t.voices)
    lo, hi = mix["prompt"]["voice_codes"]
    assert len(lens) == mix["prompt"]["voices"] and lo <= lens[0] and lens[-1] <= hi
    v = t.vocab
    for codes, words in t.voices:
        assert ((codes >= v.speech_lo) & (codes < v.speech_lo + v.speech_codes)).all()
        assert len(words) == round(len(codes) / 50 * 4)
    # every run of 8 requests speaks each voice once
    starts = {tuple(t.request(i).prompt[-8:]) for i in range(8)}
    assert len(starts) == 8
    assert (366, 1142) == t.prompt_range()


def test_ids_follow_the_port_prompt_layout():
    """The mix's vocabulary layout is the port's tokenizer's: a prompt made
    by the generator equals the port's encoding of the same prompt."""
    from tts_max_tpu_torch.core import prompting
    from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, speech_vocab

    tok = build_byte_tokenizer()
    sv = speech_vocab(tok)
    mix = harness.load_json("traffic", "clone64")
    v = traffic.Vocab(mix["vocab"])
    assert v.window == sv.generation_window() and v.eos == sv.speech_end_id
    assert sorted(sv.speech_to_token) == list(range(v.speech_lo, v.speech_lo + v.speech_codes))
    codes = [3, 70000 % 65536, 12345]
    ids = np.concatenate(v.user_prompt(mix["instruction"].encode(), np.frombuffer(
        b"abc de", np.uint8)) + [v.mark("speech_start"), sv.speech_to_token[codes]])
    want = tok.encode(prompting.compile_inference_prompt("", "abc de", codes), add_special_tokens=True)
    assert ids.tolist() == list(want)


def test_serve_rejects_a_prompt_kind_it_does_not_make():
    mix = harness.load_json("traffic", "clone64")
    mix["prompt"] = dict(mix["prompt"], kind="describe")
    with pytest.raises(ValueError, match="prompt kind"):
        traffic.ServeTraffic(mix, 0)


def test_sft_batches():
    mix = harness.load_json("traffic", "sft")
    a = traffic.SftTraffic(mix, SEEDS[1], collate_fn())
    b = traffic.SftTraffic(mix, SEEDS[1], collate_fn())
    for i in (0, 3, 17):
        x, y = a.batch(i), b.batch(i)
        assert np.array_equal(x.input_ids, y.input_ids) and np.array_equal(x.labels, y.labels)
    # the first batches hold one of each bucket, longest first
    first = [a.batch(i).input_ids.shape[1] for i in range(a.warm_batches())]
    assert first == sorted(set(a.buckets), reverse=True) == [2048, 1024, 512]
    # every seed pads the same set of batches in each block
    for seed in SEEDS:
        t = traffic.SftTraffic(mix, seed, collate_fn())
        shapes = Counter(t.batch(i).input_ids.shape for i in range(16, 32))
        assert shapes == Counter({(4, 1024): 11, (4, 2048): 3, (4, 512): 2})
    d = mix["duration_s"]
    x = a.batch(5)
    for row, lab, n in zip(x.input_ids, x.labels, x.lengths):
        assert (row[n:] == 0).all() and (lab[n:] == -100).all() and (row[:n] != 0).all()
        start = int(np.nonzero(row == mix["vocab"]["speech_start"])[0][0])
        assert (lab[:start] == -100).all() and (lab[start:n] == row[start:n]).all()
        assert row[n - 1] == mix["vocab"]["speech_end"]
        seconds = (n - start - 2) / 50
        assert d["min"] - 0.02 <= seconds <= d["max"] + 0.02


@pytest.mark.parametrize("i", [0, 5, 21])
def test_sft_reference_batches_are_padded_without_collate(i):
    """The reference's batches: the same samples, padded by the benchmark to
    their longest; collate's bucket adds only pad ids and masked labels."""
    t = traffic.SftTraffic(harness.load_json("traffic", "sft"), SEEDS[2], collate_fn())
    ids, labels = t.plain_batch(i)
    x = t.batch(i)
    assert ids.shape == (4, max(x.lengths)) and ids.shape[1] <= x.input_ids.shape[1]
    assert np.array_equal(ids, x.input_ids[:, :ids.shape[1]])
    assert np.array_equal(labels, x.labels[:, :ids.shape[1]])
    assert (x.labels[:, ids.shape[1]:] == -100).all()


def test_sft_ids_follow_the_port_layout():
    from tts_max_tpu_torch.core import prompting
    from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, speech_vocab

    tok = build_byte_tokenizer()
    sv = speech_vocab(tok)
    mix = harness.load_json("traffic", "sft")
    t = traffic.SftTraffic(mix, 3, collate_fn())
    f = t.features(0)[0]
    ids = f["input_ids"]
    start = int(np.nonzero(ids == sv.speech_start_id)[0][0])
    text = bytes((ids[29:start - 2] - 3).astype(np.uint8)).decode()  # between the text markers
    codes = sv.token_to_speech[ids[start + 1:-1]]
    want = tok.encode(prompting.compile_training_prompt(text, codes.tolist()), add_special_tokens=True)
    assert ids.tolist() == list(want)
