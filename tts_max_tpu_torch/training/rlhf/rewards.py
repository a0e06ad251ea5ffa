"""Reward functions for GRPO alignment (counterpart of
``tts_max_tpu/training/rlhf/rewards.py``).

Each reward function owns the audio decoder (the port's
``models/codec/api.AudioDecoder``); a completion's speech tokens decode to a
waveform (the prompt codes prepended for context, then the prompt's samples
trimmed); periodic wav dumping through ``data/audio_io``; WER / DNSMOS /
speaker-similarity scoring; a factory where only the first function saves
wavs.

Backends are pluggable: ``transcribe_fn`` (``asr.load_transcriber``),
``dnsmos_fn`` (``dnsmos.load_dnsmos``), ``embed_fn``
(``ecapa.load_wavlm_similarity_embedder``). Without an ``embed_fn`` the
similarity reward embeds log-mel statistics (``spectral_embed_fn``) on the
decoder's device. As in the reference, a failed decode or backend call
gives the reward's default score; the port's backends count their calls
and completions so that a caller can tell the two apart.
"""

from __future__ import annotations

import abc
import functools
import os
import uuid
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tts_max_tpu_torch.core import constants
from tts_max_tpu_torch.core.tokenization import extract_speech_ids
from tts_max_tpu_torch.data.audio_io import load_wav, save_wav
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.ops.stft import mel_spectrogram
from tts_max_tpu_torch.training.rlhf import reward_utils
from tts_max_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class RewardFunc(abc.ABC):
    """Owns the codec decoder; maps completions → waveforms → scores."""

    def __init__(
        self,
        audio_decoder,
        speech_vocab=None,
        save_completions_steps: int = 0,
        save_dir: str = "",
        logging_steps: int = 10,
    ):
        self._audio_decoder = audio_decoder
        self._sv = speech_vocab
        self._save_completions_steps = save_completions_steps
        self._save_dir = save_dir
        self.steps = 0
        self.logging_steps = logging_steps
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    @property
    def __name__(self) -> str:
        return type(self).__name__

    def _save_completion(self, audio: np.ndarray) -> None:
        if (
            self._save_completions_steps > 0
            and self._save_dir
            and self.steps % self._save_completions_steps == 0
        ):
            path = os.path.join(
                self._save_dir, f"completion_{self.steps}_{uuid.uuid4()}.wav"
            )
            save_wav(path, audio, self._audio_decoder.sample_rate)

    def _completion_speech_ids(self, completion) -> np.ndarray:
        """completion: token-id array (dense map) or string ("<|s_N|>…")."""
        if isinstance(completion, str):
            return np.asarray(extract_speech_ids(completion), dtype=np.int64)
        if self._sv is None:
            raise ValueError("token-id completions need a speech_vocab")
        return self._sv.codes_from_tokens(np.asarray(completion, dtype=np.int64))

    def _decode_audio(self, prompt_speech_ids, completion) -> np.ndarray:
        """codes → wav with the prompt prepended, then its samples trimmed.
        Returns [1, n] (possibly n=0)."""
        gen = self._completion_speech_ids(completion)
        if gen.size == 0:
            log.warning("empty generated speech ids; returning empty audio")
            return np.zeros((1, 0), dtype=np.float32)
        prompt = np.asarray(prompt_speech_ids, dtype=np.int64)
        try:
            wav = self._audio_decoder.decode(np.concatenate([prompt, gen]))
            prompt_samples = int(
                len(prompt)
                / self._audio_decoder.token_rate
                * self._audio_decoder.sample_rate
            )
            final = wav[:, prompt_samples:]
            self._save_completion(final)
            return final
        except Exception as e:
            log.error("Error decoding completion audio: %s", e)
            return np.zeros((1, 0), dtype=np.float32)

    @abc.abstractmethod
    def __call__(self, completions: Sequence[Any], **kwargs) -> list[float]:
        ...


class WERRewardFunc(RewardFunc):
    """reward = exp(-2.5·WER) via a pluggable ASR."""

    def __init__(self, *args, transcribe_fn: Callable | None = None, **kw):
        super().__init__(*args, **kw)
        self._transcribe = transcribe_fn

    def __call__(self, completions, **kwargs):
        rewards = []
        for prompt_ids, completion, truth, language in zip(
            kwargs["prompt_speech_ids"], completions,
            kwargs["completion_truth"], kwargs["language"],
        ):
            wav = self._decode_audio(prompt_ids, completion)
            if self._transcribe is None:
                rewards.append(reward_utils.normalize_wer(reward_utils.DEFAULT_WER))
                continue
            wer = reward_utils.eval_wer(
                self._transcribe, wav, self._audio_decoder.sample_rate, truth,
                language,
            )
            rewards.append(reward_utils.normalize_wer(wer))
        self.steps += 1
        if self.steps % self.logging_steps == 0:
            log.info("WERRewardFunc rewards: %s", rewards)
        return rewards


class DNSMOSRewardFunc(RewardFunc):
    """Speech-quality MOS reward via a pluggable dnsmos_fn."""

    def __init__(self, *args, dnsmos_fn: Callable | None = None, **kw):
        super().__init__(*args, **kw)
        self._dnsmos = dnsmos_fn

    def __call__(self, completions, **kwargs):
        rewards = []
        for prompt_ids, completion in zip(kwargs["prompt_speech_ids"], completions):
            wav = self._decode_audio(prompt_ids, completion)
            if wav.shape[1] == 0 or self._dnsmos is None:
                rewards.append(reward_utils.normalize_dnsmos(1.0))
                continue
            try:
                mos = float(self._dnsmos(wav[0], self._audio_decoder.sample_rate))
            except Exception as e:
                log.error("dnsmos failed: %s", e)
                mos = 1.0
            rewards.append(reward_utils.normalize_dnsmos(mos))
        self.steps += 1
        return rewards


@torch.inference_mode()
def spectral_embed_fn(audio: np.ndarray, device="cuda") -> np.ndarray:
    """Dependency-free speaker-embedding fallback: log-mel statistics
    (mean/std over time, on the host in numpy) of a mel computed on
    ``device``. A WavLM/ECAPA backend plugs in via ``embed_fn``."""
    x = torch.as_tensor(np.asarray(audio, dtype=np.float32), device=resolve_device(device))
    mel = mel_spectrogram(x[None], 16000, 512, 160, 40)
    logm = torch.log(torch.clamp_min(mel, 1e-5)).cpu().numpy()[0]  # [40, T]
    return np.concatenate([logm.mean(axis=1), logm.std(axis=1)])


class SimilarityRewardFunc(RewardFunc):
    """Speaker-similarity reward: cosine between embeddings of the prompt
    wav and the completion."""

    def __init__(self, *args, embed_fn: Callable | None = None, **kw):
        super().__init__(*args, **kw)
        self._embed = embed_fn or functools.partial(
            spectral_embed_fn, device=getattr(self._audio_decoder, "device", "cuda"))

    def __call__(self, completions, **kwargs):
        rewards = []
        for prompt_ids, completion, wav_path in zip(
            kwargs["prompt_speech_ids"], completions, kwargs["prompt_wav_path"]
        ):
            wav = self._decode_audio(prompt_ids, completion)
            try:
                prompt_wav, _ = load_wav(wav_path, reward_utils.EVAL_SAMPLE_RATE)
            except Exception:
                rewards.append(reward_utils.normalize_similarity(0.0))
                continue
            sim = reward_utils.eval_similarity(self._embed, prompt_wav[0], wav[0])
            rewards.append(reward_utils.normalize_similarity(sim))
        self.steps += 1
        return rewards


REWARD_CLASSES = {
    constants.WER_REWARD_FUNC: WERRewardFunc,
    constants.DNSMOS_REWARD_FUNC: DNSMOSRewardFunc,
    constants.SIMILARITY_REWARD_FUNC: SimilarityRewardFunc,
    "wer": WERRewardFunc,
    "dnsmos": DNSMOSRewardFunc,
    "similarity": SimilarityRewardFunc,
}


def create_reward_funcs(
    reward_func_names: Sequence[str],
    audio_decoder,
    speech_vocab=None,
    save_completions_steps: int = 0,
    save_dir: str = "",
    logging_steps: int = 10,
    backends: dict | None = None,
) -> list[RewardFunc]:
    """Factory: only the FIRST function saves wavs."""
    backends = backends or {}
    funcs = []
    for i, name in enumerate(reward_func_names):
        cls = REWARD_CLASSES.get(name)
        if cls is None:
            raise ValueError(f"unknown reward func {name!r}")
        kw = dict(
            audio_decoder=audio_decoder,
            speech_vocab=speech_vocab,
            save_completions_steps=save_completions_steps if i == 0 else 0,
            save_dir=save_dir if i == 0 else "",
            logging_steps=logging_steps,
        )
        if cls is WERRewardFunc:
            kw["transcribe_fn"] = backends.get("transcribe_fn")
        elif cls is DNSMOSRewardFunc:
            kw["dnsmos_fn"] = backends.get("dnsmos_fn")
        elif cls is SimilarityRewardFunc:
            kw["embed_fn"] = backends.get("embed_fn")
        funcs.append(cls(**kw))
    return funcs
