"""Training-time quality validation: real synthesis at each checkpoint
(counterpart of ``tts_max_tpu/inference/quality.py``).

- ``RandomPhrasesSynthesizer``: prompt wavs x test phrases, statically
  sharded across processes, synthesized and written per checkpoint;
- ``PromptContinuationValidator``: speech continuation of prompt wavs, on
  process 0 only;
- ``NoOpQualityValidator`` and a ``create`` factory by validation_type.

The validators point the ``LocalTtsModel`` at the training params they are
given (``model._params``), as the JAX package does, and synthesize through
``generate``, which runs in inference mode on those tensors; nothing of the
params is changed, and the next training step runs as before. Each combo
catches and logs its own exception: validation must never kill training.
"""

from __future__ import annotations

import abc
import os
from typing import Sequence

from tts_max_tpu_torch.core.constants import CODEC_SAMPLE_RATE
from tts_max_tpu_torch.data.audio_io import load_wav, save_wav
from tts_max_tpu_torch.data.normalization import create as create_normalizer
from tts_max_tpu_torch.inference.synthesize import InferenceSettings, LocalTtsModel
from tts_max_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# 21 validation phrases, the JAX package's
DEFAULT_PHRASES = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells seashells by the seashore.",
    "A journey of a thousand miles begins with a single step.",
    "The early bird catches the worm, or so they say.",
    "Can you believe how fast this year has gone by?",
    "Please leave a message after the tone.",
    "The weather tomorrow will be sunny with a chance of rain.",
    "Seventeen students signed up for the science seminar.",
    "I'd like to order a large pizza with extra cheese.",
    "The train to Boston departs from platform nine.",
    "Music has a way of bringing people together.",
    "Remember to water the plants while I'm away.",
    "The meeting has been rescheduled to three o'clock.",
    "He whispered the secret so quietly that nobody heard.",
    "Bright city lights reflected off the wet pavement.",
    "Two plus two equals four, obviously.",
    "The recipe calls for a pinch of salt and a dash of pepper.",
    "Her laughter echoed through the empty hallway.",
    "Don't forget to charge your phone before the trip.",
    "The museum exhibit features paintings from the nineteenth century.",
    "Every cloud has a silver lining.",
]


def all_test_combinations(prompt_wavs: dict[str, str], phrases: Sequence[str]
                          ) -> list[tuple[str, str, str]]:
    """The (wav_path, prompt_text, phrase) grid, wavs in sorted order."""
    return [(wav_path, prompt_text, phrase)
            for wav_path, prompt_text in sorted(prompt_wavs.items()) for phrase in phrases]


def shard_combinations(combos: list, rank: int, world: int) -> list:
    """Process ``rank``'s static share of ``combos``."""
    if world == 1:
        return combos
    n = len(combos)
    left = (rank * n) // world
    right = min(((rank + 1) * n) // world, n)
    return combos[left:right]


class QualityValidator(abc.ABC):
    @abc.abstractmethod
    def validate(self, params, step: int) -> None:
        ...


class NoOpQualityValidator(QualityValidator):
    def validate(self, params, step: int) -> None:
        del params, step


class RandomPhrasesSynthesizer(QualityValidator):
    """Synthesize this process's (prompt x phrase) combinations at each
    checkpoint into ``<dir>/generations/<step>/rank<r>_<i>.wav``."""

    def __init__(self, model: LocalTtsModel, checkpointing_dir: str, global_rank: int = 0,
                 world_size: int = 1, prompt_wavs: dict[str, str] | None = None,
                 phrases: Sequence[str] | None = None,
                 settings: InferenceSettings | None = None,
                 enable_text_normalization: bool = True):
        self._model = model
        self._dir = checkpointing_dir
        self._rank = global_rank
        self._world = world_size
        self._prompt_wavs = prompt_wavs or {}
        self._phrases = list(phrases or DEFAULT_PHRASES)
        self._settings = settings or InferenceSettings(max_tokens=256)
        self._normalizer = create_normalizer(enable_text_normalization)

    def validate(self, params, step: int) -> None:
        self._model._params = params  # the latest weights
        combos = shard_combinations(all_test_combinations(self._prompt_wavs, self._phrases),
                                    self._rank, self._world)
        out_dir = os.path.join(self._dir, f"generations/{step}")
        os.makedirs(out_dir, exist_ok=True)
        for i, (wav_path, prompt_text, phrase) in enumerate(combos):
            try:
                wav, _ = load_wav(wav_path, CODEC_SAMPLE_RATE)
                phrase_n = self._normalizer.normalize_with_language(phrase, "en")
                res = self._model.synthesize_speech(
                    self._settings, text_to_synthesize=phrase_n, prompt_id=wav_path,
                    prompt_wav=wav[0], audio_prompt_transcription=prompt_text)
                save_wav(os.path.join(out_dir, f"rank{self._rank}_{i}.wav"), res.wav,
                         self._model._audio_decoder.sample_rate)
            except Exception as e:  # validation must never kill training
                log.warning("Quality validation combo %d failed: %s", i, e)
        log.info("Step %d: wrote %d validation wavs to %s", step, len(combos), out_dir)


class PromptContinuationValidator(QualityValidator):
    """Continue each prompt wav at each checkpoint, on process 0 only, into
    ``<dir>/continuations/<step>/continuation_<i>.wav``."""

    def __init__(self, model: LocalTtsModel, checkpointing_dir: str,
                 prompt_wav_paths: Sequence[str], global_rank: int = 0,
                 settings: InferenceSettings | None = None):
        self._model = model
        self._dir = checkpointing_dir
        self._paths = list(prompt_wav_paths)
        self._rank = global_rank
        self._settings = settings or InferenceSettings(max_tokens=256)

    def validate(self, params, step: int) -> None:
        if self._rank != 0:
            return
        self._model._params = params
        out_dir = os.path.join(self._dir, f"continuations/{step}")
        os.makedirs(out_dir, exist_ok=True)
        for i, path in enumerate(self._paths):
            try:
                wav, _ = load_wav(path, CODEC_SAMPLE_RATE)
                cont = self._model.complete_prompt(wav[0], self._settings)
                save_wav(os.path.join(out_dir, f"continuation_{i}.wav"), cont,
                         self._model._audio_decoder.sample_rate)
            except Exception as e:  # validation must never kill training
                log.warning("Continuation %d failed: %s", i, e)


def create(validation_type: str, model: LocalTtsModel | None = None,
           checkpointing_dir: str = "", global_rank: int = 0, world_size: int = 1,
           prompt_wavs: dict[str, str] | None = None,
           prompt_wav_paths: Sequence[str] | None = None) -> QualityValidator:
    """The validator of ``validation_type``: "none" (or empty),
    "random_phrases" or "prompt_continuation"."""
    if validation_type in ("none", "", None):
        return NoOpQualityValidator()
    if validation_type == "random_phrases":
        return RandomPhrasesSynthesizer(model, checkpointing_dir, global_rank, world_size,
                                        prompt_wavs)
    if validation_type == "prompt_continuation":
        return PromptContinuationValidator(model, checkpointing_dir, prompt_wav_paths or [],
                                           global_rank)
    raise ValueError(f"unknown validation_type {validation_type!r}")
