"""Codec GAN training data (counterpart of
``tts_max_tpu/training/codec/codec_data.py``): aligned windows of
``code_window_size`` codes and ``code_window_size * hop`` wav samples from a
vectorized dataset (its codes and the original wavs its samples name). Wavs
are padded to a hop multiple, clips shorter than the window repeat, and the
window starts at a code drawn from the dataset's own
``np.random.default_rng(seed)``, one draw per ``__getitem__``: items read
in the same order give the same windows as JAX's.
"""

from __future__ import annotations

import numpy as np

from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.audio_io import load_wav


class CodecTrainingDataset:
    def __init__(self, dataset_dir: str, split: str, code_window_size: int = 80,
                 hop_length: int = 320, sample_rate: int = 16000, min_sample_rate: int = 0,
                 seed: int = 0):
        self.code_window = code_window_size
        self.audio_window = code_window_size * hop_length
        self.hop = hop_length
        self.sample_rate = sample_rate
        codes, samples, spans, _ = codes_io.load_and_filter_audio_codes_and_samples(
            dataset_dir, split, None)
        if min_sample_rate:
            keep = [i for i, s in enumerate(samples) if s.sample_rate >= min_sample_rate]
            samples = [samples[i] for i in keep]
            spans = [spans[i] for i in keep]
        self.codes = codes
        self.samples = samples
        self.spans = spans
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        start, end = self.spans[idx]
        codes = np.asarray(self.codes[start:end], dtype=np.int32)
        wav = load_wav(self.samples[idx].wav_path, self.sample_rate)[0][0]
        if len(wav) % self.hop:
            wav = np.pad(wav, (0, self.hop - len(wav) % self.hop))
        n = min(len(codes), len(wav) // self.hop)  # codes and wav aligned to the shorter
        codes, wav = codes[:n], wav[:n * self.hop]
        while len(codes) < self.code_window:
            codes = np.concatenate([codes, codes])
            wav = np.concatenate([wav, wav])
        c0 = int(self._rng.integers(0, len(codes) - self.code_window + 1))
        return {
            "audio_codes": codes[c0:c0 + self.code_window],
            "wav": wav[c0 * self.hop:c0 * self.hop + self.audio_window].astype(np.float32),
            "tokens_processed": self.code_window,
            "audio_processed_sec": self.audio_window / self.sample_rate,
        }


def codec_collate(items: list[dict]) -> dict:
    """Fixed windows, so batches stack without padding."""
    if sum(len(x) for x in items) == 0:
        return {}
    return {
        "audio_codes": np.stack([x["audio_codes"] for x in items]),
        "wav": np.stack([x["wav"] for x in items]),
        "tokens_processed": np.asarray([x["tokens_processed"] for x in items]),
        "audio_processed_sec": np.asarray([x["audio_processed_sec"] for x in items]),
        "source": [x.get("source", "codec") for x in items],
    }
