"""End-user TTS inference: text (+ voice prompt) → waveform (counterpart of
``tts_max_tpu/inference/synthesize.py``).

``LocalTtsModel.synthesize_speech``: normalize the text, encode the prompt
audio (unless a voice description replaces it), compile and tokenize the
prompt, generate speech tokens (``inference/generate.py``), map them to
codec codes through the dense ``SpeechVocab`` and decode them to a wav with
the prompt-audio region trimmed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from tts_max_tpu_torch.core import prompting
from tts_max_tpu_torch.core.tokenization import SpeechVocab
from tts_max_tpu_torch.data import normalization
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.inference.generate import generate
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.ops.sampling import SamplingParams


@dataclasses.dataclass
class InferenceSettings:
    """Defaults mirror the JAX package's InferenceSettings."""

    temperature: float = 0.8
    max_tokens: int = 1792
    min_tokens: int = 10
    top_p: float = 1.0
    top_k: int = 50
    repetition_penalty: float = 1.1
    frequency_penalty: float = 0.3
    seed: int = 42
    # Sample only inside the speech-token window (speech tokens + structural
    # markers, SpeechVocab.generation_window): every generated token is a
    # legal speech-segment token, and the per-step LM-head read is ~3x
    # smaller at the 193856-token vocab.
    constrain_to_speech: bool = True

    def sampling_params(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            repetition_penalty=self.repetition_penalty,
            frequency_penalty=self.frequency_penalty,
            max_new_tokens=self.max_tokens,
        )


@dataclasses.dataclass(frozen=True)
class InferenceResult:
    wav: np.ndarray
    encoding_time: float  # seconds spent encoding the prompt audio
    decoding_time: float  # seconds in the codec decoder
    inference_time: float  # seconds from tokenization to the wav
    prefill_time: float = 0.0  # seconds of the generator's prefill
    decode_time: float = 0.0  # seconds of the generator's decode loop
    decode_steps: int = 0  # decode iterations the generator ran


def _bucket(n: int, step: int = 64) -> int:
    return ((n + step - 1) // step) * step


class LocalTtsModel:
    """Local TTS inference on ``device`` (CUDA unless the caller asks for
    the CPU). ``audio_encoder`` is any object with
    ``encode(prompt_id, wav) -> codes`` (e.g. ``api.CachingAudioEncoder``)."""

    def __init__(
        self,
        params: Any,
        cfg: llama.LlamaConfig,
        tokenizer,
        speech_vocab: SpeechVocab,
        audio_encoder,
        audio_decoder,
        normalizer=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self._params = params
        self._cfg = cfg
        self._tokenizer = tokenizer
        self._sv = speech_vocab
        self._audio_encoder = audio_encoder
        self._audio_decoder = audio_decoder
        self._normalizer = normalizer or normalization.create()

    def _vocab_window(self, settings: InferenceSettings):
        if not settings.constrain_to_speech:
            return None
        lo, size = self._sv.generation_window()
        if lo + size > self._cfg.vocab_size:  # tokenizer outgrew the model
            return None
        return (lo, size)

    def _generate(self, input_ids: np.ndarray, settings: InferenceSettings):
        """Prompt right-padded to a multiple of 64; one cache of
        ``bucket + max_tokens`` rows."""
        n = len(input_ids)
        bucket = _bucket(n)
        padded = np.zeros((1, bucket), dtype=np.int32)
        padded[0, :n] = input_ids
        res = generate(
            self._params, self._cfg, padded, np.asarray([n], dtype=np.int32),
            torch.Generator(device=self.device).manual_seed(settings.seed),
            sp=settings.sampling_params(),
            max_new_tokens=settings.max_tokens,
            eos_id=self._sv.speech_end_id,
            cache_len=bucket + settings.max_tokens,
            vocab_window=self._vocab_window(settings),
            min_new_tokens=settings.min_tokens,
            device=self.device,
        )
        toks = res.tokens[0, : int(res.num_generated[0])].cpu().numpy()
        return toks, res

    def synthesize_speech(
        self,
        inference_settings: InferenceSettings,
        text_to_synthesize: str,
        prompt_id: str,
        prompt_wav,
        audio_prompt_transcription: str,
        voice_description: str = "",
        enable_instruction: bool = True,
        language: str | None = None,
    ) -> InferenceResult:
        text_to_synthesize = self._normalizer.normalize(text_to_synthesize, language)
        speech_ids: list[int] = []
        encoding_time = 0.0
        if not voice_description or enable_instruction:
            t0 = time.perf_counter()
            # encode returns [T] for a 1-D wav and [1, T] for [1, n] wavs
            speech_ids = np.asarray(
                self._audio_encoder.encode(prompt_id, prompt_wav)
            ).ravel().tolist()
            encoding_time = time.perf_counter() - t0

        prompt = prompting.compile_inference_prompt(
            audio_prompt_transcription,
            text_to_synthesize,
            speech_ids,
            voice_description,
            enable_instruction,
        )
        t0 = time.perf_counter()
        input_ids = np.asarray(
            self._tokenizer.encode(prompt, add_special_tokens=True), dtype=np.int32
        )
        generated, res = self._generate(input_ids, inference_settings)
        # keep only speech tokens; prepend the prompt's speech ids so the
        # decoder sees contiguous context
        gen_speech = self._sv.codes_from_tokens(generated)
        all_codes = np.concatenate([np.asarray(speech_ids, dtype=np.int64), gen_speech])
        t1 = time.perf_counter()
        wav = self._audio_decoder.decode(all_codes)
        decoding_time = time.perf_counter() - t1
        inference_time = time.perf_counter() - t0

        # trim the prompt-audio region
        prompt_samples = int(
            len(speech_ids)
            / self._audio_decoder.token_rate
            * self._audio_decoder.sample_rate
        )
        return InferenceResult(
            wav=wav[:, prompt_samples:],
            encoding_time=encoding_time,
            decoding_time=decoding_time,
            inference_time=inference_time,
            prefill_time=res.prefill_time,
            decode_time=res.decode_time,
            decode_steps=res.steps,
        )

    def complete_prompt(self, prompt_wav, inference_settings: InferenceSettings
                        ) -> np.ndarray:
        """Pure speech continuation of the prompt audio."""
        codes = np.asarray(
            self._audio_encoder.encode("__complete__", prompt_wav)
        ).ravel().astype(np.int64)
        input_ids = np.concatenate(
            [[self._sv.speech_start_id], self._sv.tokens_from_codes(codes)]
        ).astype(np.int32)
        generated, _ = self._generate(input_ids, inference_settings)
        all_codes = np.concatenate([codes, self._sv.codes_from_tokens(generated)])
        wav = self._audio_decoder.decode(all_codes)
        prompt_samples = int(
            len(codes) / self._audio_decoder.token_rate * self._audio_decoder.sample_rate
        )
        return wav[:, prompt_samples:]
