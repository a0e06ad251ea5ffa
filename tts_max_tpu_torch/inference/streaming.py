"""Streaming TTS: incremental codec decoding + chunked synthesis (counterpart
of ``tts_max_tpu/inference/streaming.py``).

Audio is emitted while the SpeechLM is still generating. The Vocos decoder
is non-causal (full attention over the code window), so exact streaming is
impossible; each chunk re-decodes with ``context`` codes of left history.
With enough context the interior converges to the offline decode.

``StreamingSynthesizer`` drives the port's contiguous engine poll by poll
and yields wav chunks as soon as enough new codes exist.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class StreamingDecoder:
    """Incremental FSQ codes -> waveform, over any decoder with
    ``decode(codes) -> [1, samples]``, ``sample_rate`` and ``token_rate``
    (``api.AudioDecoder``).

    Each chunk of ``chunk_codes`` is decoded with up to ``context_codes`` of
    left history, and its own samples are emitted. A chunk is emitted once
    ``crossfade_codes`` more codes have arrived behind it. The JAX package's
    decoder also keeps a crossfade tail, but its decode window ends where the
    chunk ends, so the tail is never filled and no chunk is ever faded
    (tts_max_tpu/inference/streaming.py:75-89); the port emits the same
    samples without that dead code."""

    def __init__(self, audio_decoder, chunk_codes: int = 25, context_codes: int = 50,
                 crossfade_codes: int = 4, history=None):
        """``history``: codes that precede the stream (e.g. the voice-prompt
        audio's codes): they condition the decode context but are never
        emitted, as the offline path trims the prompt region."""
        self._decoder = audio_decoder
        self.chunk = chunk_codes
        self.context = context_codes
        self.crossfade = crossfade_codes
        self._hop = audio_decoder.sample_rate // audio_decoder.token_rate
        self._codes: list[int] = (np.asarray(history, dtype=np.int64).ravel().tolist()
                                  if history is not None else [])
        self._emitted_codes = len(self._codes)

    def push(self, codes) -> np.ndarray:
        """Add codes; return newly ready audio samples (possibly none)."""
        self._codes.extend(np.asarray(codes, dtype=np.int64).ravel().tolist())
        out = []
        while len(self._codes) - self._emitted_codes >= self.chunk + self.crossfade:
            out.append(self._decode_next(final=False))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.float32)

    def flush(self) -> np.ndarray:
        """Decode whatever remains."""
        out = []
        while len(self._codes) > self._emitted_codes:
            out.append(self._decode_next(final=True))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.float32)

    def _decode_next(self, final: bool) -> np.ndarray:
        start = self._emitted_codes
        end = len(self._codes) if final else min(start + self.chunk, len(self._codes))
        ctx_start = max(0, start - self.context)
        wav = self._decoder.decode(np.asarray(self._codes[ctx_start:end], dtype=np.int64))[0]
        self._emitted_codes = end
        return wav[(start - ctx_start) * self._hop:(end - ctx_start) * self._hop].astype(
            np.float32)


class StreamingSynthesizer:
    """text (+ prompt) -> iterator of wav chunks, driven by the engine."""

    def __init__(self, engine, tokenizer, speech_vocab, audio_decoder,
                 chunk_codes: int = 25, context_codes: int = 50):
        self._engine = engine
        self._tokenizer = tokenizer
        self._sv = speech_vocab
        self._decoder = audio_decoder
        self._chunk = chunk_codes
        self._context = context_codes

    def stream(self, prompt: str, max_new_tokens: int = 1792, seed: int = 0,
               input_ids: np.ndarray | None = None) -> Iterator[np.ndarray]:
        """``input_ids``: a pre-tokenized prompt (skips the tokenizer)."""
        if input_ids is None:
            input_ids = self._tokenizer.encode(prompt, add_special_tokens=True)
        input_ids = np.asarray(input_ids, dtype=np.int32)
        rid = self._engine.submit(input_ids, max_new_tokens, eos_id=self._sv.speech_end_id,
                                  sampling_seed=seed)
        sd = StreamingDecoder(self._decoder, self._chunk, self._context)
        n_consumed = 0
        done = False
        while not done:
            finished = self._engine.poll()
            done = (any(c.request_id == rid for c in finished)
                    or not self._engine.has_work())
            # the tokens generated so far: the slot's, or the completion's
            tokens = next((s.generated for s in self._engine._slots
                           if s.request is not None and s.request.request_id == rid), None)
            if tokens is None:
                tokens = next((c.tokens.tolist() for c in finished if c.request_id == rid),
                              None)
            if tokens is None:
                continue
            # count consumed in token space (codes_from_tokens drops markers)
            codes = self._sv.codes_from_tokens(np.asarray(tokens[n_consumed:], np.int64))
            n_consumed = len(tokens)
            if len(codes):
                piece = sd.push(codes)
                if len(piece):
                    yield piece
        tail = sd.flush()
        if len(tail):
            yield tail
