"""The one general generator of the benchmark's traffic.

A traffic mix is a JSON file under ``benchmark/traffic/`` that holds only
parameters; ``kind`` says which of the two families below reads it:

- ``tts_serve``: requests for a serving engine, as prompt ids in the port's
  inference prompt layout (``core/prompting.compile_inference_prompt``:
  instruction, transcript and text, ``<|speech_start|>``, the voice prompt's
  speech codes), an output budget, and greedy or default sampling.
- ``tts_sft``: collated SFT batches in the training prompt layout
  (``compile_training_prompt``), labels from ``<|speech_start|>`` on.

Ids are made here from the vocabulary layout the mix states (bytes at
``byte_offset``, the speech codes' id block, the markers), never by the
program's tokenizer. Every seed gets the same set of sizes: lengths are
quantiles of the stated distributions, laid out in blocks that each hold the
whole set, and the seed draws only their order and the ids.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)


def lognormal_quantiles(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """The n quantiles at (k + 1/2) / n of a lognormal clipped to [lo, hi]."""
    z = np.array([NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def uniform_quantiles(n: int, lo: float, hi: float) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


class Vocab:
    """The id layout a mix states: BOS, bytes, the speech codes' block and
    the markers."""

    def __init__(self, v: dict):
        self.v = v
        self.bos = v["bos"]
        self.speech_lo, self.speech_codes = v["speech_lo"], v["speech_codes"]
        self.window = tuple(v["window"])
        self.eos = v["speech_end"]

    def text(self, s: bytes | np.ndarray) -> np.ndarray:
        return np.frombuffer(bytes(s), dtype=np.uint8).astype(np.int32) + self.v["byte_offset"]

    def mark(self, name: str) -> np.ndarray:
        return np.asarray([self.v[name]], dtype=np.int32)

    def user_prompt(self, instruction: bytes, transcript: np.ndarray) -> list[np.ndarray]:
        """The user message and the newline before the assistant message."""
        return [np.asarray([self.bos], np.int32), self.text(instruction),
                self.mark("text_prompt_start"), self.text(transcript),
                self.mark("text_prompt_end"), self.text(b"\n")]


def _letters(rng: np.random.Generator, n: int) -> np.ndarray:
    out = LETTERS[rng.integers(0, len(LETTERS), size=max(1, n))]
    out[0] = ord("a")  # no leading space
    return out


@dataclass
class ServeRequest:
    index: int
    prompt: np.ndarray  # int32 ids
    budget: int  # max_new_tokens
    greedy: bool
    sampling_seed: int


class ServeTraffic:
    """Requests ``0, 1, 2, ...`` of a ``tts_serve`` mix for ``seed``.

    Block b holds requests [b*B, (b+1)*B), B = ``block``: its budgets are the
    B quantiles of the output distribution in a seeded order, every run of
    ``voices`` requests speaks each voice once, and every run of
    ``greedy_every`` requests holds one greedy request (temperature 0, no
    penalties), the rest use the engine's default sampling."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, seed
        self.vocab = Vocab(mix["vocab"])
        self.block = mix["block"]
        out = mix["output"]
        self.budgets = np.rint(lognormal_quantiles(
            self.block, out["median_tokens"], out["sigma"], out["min_tokens"],
            out["max_tokens"])).astype(int)
        rng = np.random.default_rng([seed, 0])
        p = mix["prompt"]
        self.instruction = mix["instruction"].encode()
        self.voices = []
        if p["kind"] == "clone":
            n = p["voices"]
            lens = np.rint(uniform_quantiles(n, *p["voice_codes"])).astype(int)[rng.permutation(n)]
            for length in lens:
                codes = rng.integers(0, self.vocab.speech_codes, size=length) + self.vocab.speech_lo
                words = round(length / p["codes_per_s"] * p["transcript_tokens_per_s"])
                self.voices.append((codes.astype(np.int32), _letters(rng, words)))
        else:
            raise ValueError(f"unknown prompt kind {p['kind']!r}")

    def _prompt(self, voice: int, budget: int, rng: np.random.Generator) -> np.ndarray:
        codes, transcript = self.voices[voice]
        out = self.mix["output"]
        text = _letters(rng, round(budget / out["codes_per_s"] * out["text_tokens_per_s"]))
        words = np.concatenate([transcript, LETTERS[-1:], text])
        parts = self.vocab.user_prompt(self.instruction, words)
        return np.concatenate(parts + [self.vocab.mark("speech_start"), codes]).astype(np.int32)

    def request(self, i: int) -> ServeRequest:
        b, pos = divmod(i, self.block)
        rng = np.random.default_rng([self.seed, 1, b])
        order = rng.permutation(self.block)
        nv, g = len(self.voices), self.mix["greedy_every"]
        voice_order = rng.permuted(np.tile(np.arange(nv), (self.block // nv, 1)), axis=1).ravel()
        greedy_pos = rng.integers(0, g, size=self.block // g)
        budget = int(self.budgets[order[pos]])
        prompt = self._prompt(int(voice_order[pos]), budget, np.random.default_rng([self.seed, 2, i]))
        return ServeRequest(i, prompt, budget, bool(pos % g == greedy_pos[pos // g]),
                            int(np.random.default_rng([self.seed, 3, i]).integers(0, 2 ** 31)))

    def prompt_range(self) -> tuple[int, int]:
        """The shortest and longest prompt the mix can make: every voice
        with the shortest and the longest budget."""
        rng = np.random.default_rng(0)
        lens = [len(self._prompt(v, int(b), rng)) for v in range(len(self.voices))
                for b in (self.budgets.min(), self.budgets.max())]
        return min(lens), max(lens)


def prompt_buckets(lo: int, hi: int, step: int = 64) -> tuple[int, ...]:
    """Every multiple of ``step`` a prompt of lo..hi tokens pads to (the
    contiguous engine's prefill buckets)."""
    first = max(step, math.ceil(lo / step) * step)
    return tuple(range(first, math.ceil(hi / step) * step + 1, step))


@dataclass
class SftBatch:
    input_ids: np.ndarray  # [B, bucket] int32
    labels: np.ndarray  # [B, bucket] int32, -100 where no loss
    tokens: int  # non-pad tokens
    lengths: list[int]  # each sample's tokens


class SftTraffic:
    """Batches ``0, 1, 2, ...`` of a ``tts_sft`` mix for ``seed``, through
    ``collate`` (the caller's, so the program's padding is what is timed).

    Block b holds ``block_batches`` batches of ``batch_size`` samples: the
    block's sample durations are the quantiles of the stated distribution,
    grouped into batches by a fixed assignment (the same for every seed),
    and the seed orders the batches. Block 0 starts with one batch of each
    bucket the block holds, longest first, so the first steps meet every
    shape the run will see."""

    def __init__(self, mix: dict, seed: int, collate):
        self.mix, self.seed, self.collate = mix, seed, collate
        self.vocab = Vocab(mix["vocab"])
        d = mix["duration_s"]
        bs, nb = mix["batch_size"], mix["block_batches"]
        durations = lognormal_quantiles(bs * nb, d["median"], d["sigma"], d["min"], d["max"])
        groups = np.random.default_rng(0).permutation(bs * nb).reshape(nb, bs)
        self.batch_durations = durations[groups]  # [nb, bs], fixed for every seed
        self.buckets = [self._bucket(row) for row in self.batch_durations]

    def sample_tokens(self, seconds: float) -> int:
        m = self.mix
        return (len(self._markup(np.zeros(0, np.uint8))) + round(seconds * m["text_tokens_per_s"])
                + round(seconds * m["codes_per_s"]) + 1)

    def _markup(self, text):
        return np.concatenate(self.vocab.user_prompt(self.mix["instruction"].encode(), text)
                              + [self.vocab.mark("speech_start")])

    def _bucket(self, durations) -> int:
        from math import inf

        longest = max(self.sample_tokens(s) for s in durations)
        for b in self.mix["buckets"]:
            if longest <= b:
                return b
        return inf

    def order(self, block: int) -> np.ndarray:
        nb = len(self.buckets)
        rng = np.random.default_rng([self.seed, 1, block])
        perm = rng.permutation(nb)
        if block == 0:
            first = []
            for b in sorted(set(self.buckets), reverse=True):
                first.append(next(int(i) for i in perm if self.buckets[i] == b))
            perm = np.asarray(first + [int(i) for i in perm if int(i) not in first])
        return perm

    def warm_batches(self) -> int:
        """How many leading batches hold one of each bucket."""
        return len(set(self.buckets))

    def features(self, i: int) -> list[dict]:
        nb = len(self.buckets)
        block, pos = divmod(i, nb)
        row = self.order(block)[pos]
        rng = np.random.default_rng([self.seed, 2, i])
        m = self.mix
        out = []
        for seconds in self.batch_durations[row]:
            text = _letters(rng, round(seconds * m["text_tokens_per_s"]))
            codes = rng.integers(0, self.vocab.speech_codes, size=round(seconds * m["codes_per_s"]))
            ids = np.concatenate([self._markup(text), codes.astype(np.int32) + self.vocab.speech_lo,
                                  self.vocab.mark("speech_end")]).astype(np.int32)
            labels = np.full_like(ids, -100)
            start = int(np.nonzero(ids == self.vocab.v["speech_start"])[0][0])
            labels[start:] = ids[start:]
            out.append({"input_ids": ids, "labels": labels, "tokens_processed": len(ids),
                        "audio_processed_sec": float(seconds)})
        return out

    def plain_batch(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Batch i padded by the benchmark itself, for the reference: to its
        longest sample, the pad id past each sample's end and label -100
        there (``collate``'s buckets add only masked positions)."""
        feats = self.features(i)
        width = max(len(f["input_ids"]) for f in feats)
        ids = np.full((len(feats), width), self.vocab.v["pad"], np.int32)
        labels = np.full((len(feats), width), -100, np.int32)
        for row, f in enumerate(feats):
            ids[row, :len(f["input_ids"])] = f["input_ids"]
            labels[row, :len(f["labels"])] = f["labels"]
        return ids, labels

    def batch(self, i: int) -> SftBatch:
        feats = self.features(i)
        b = self.collate(feats)
        lengths = [len(f["input_ids"]) for f in feats]
        return SftBatch(b["input_ids"], b["labels"], sum(lengths), lengths)
