"""RLHF prompt dataset (counterpart of ``tts_max_tpu/training/rlhf/dataset.py``).

prompt = the inference prompt of this sample's audio prompt and the NEXT
sample's transcript as the text to synthesize; yields {prompt,
prompt_speech_ids, completion_truth, prompt_wav_path, language}.
"""

from __future__ import annotations

import numpy as np

from tts_max_tpu_torch.core import prompting
from tts_max_tpu_torch.data.normalization import NoOpTextNormalizer


class TtsRLHFDataset:
    def __init__(
        self,
        dataset_name: str,
        samples: list,
        codes: np.ndarray,
        indexes: list[tuple[int, int]],
        tokenizer,
        text_normalizer=None,
    ):
        if len(indexes) != len(samples):
            raise ValueError("The number of samples and codes must match!")
        self.dataset_name = dataset_name
        self.samples = samples
        self.codes = codes
        self.indexes = indexes
        self.tokenizer = tokenizer
        self.normalizer = text_normalizer or NoOpTextNormalizer()

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        start, end = self.indexes[idx]
        speech_ids = np.asarray(self.codes[start:end])
        sample = self.samples[idx]
        transcript = self.normalizer.normalize_with_language(
            sample.transcript, sample.language
        )
        # the next sample's transcript is the target text
        next_sample = self.samples[(idx + 1) % len(self.samples)]
        completion_truth = self.normalizer.normalize_with_language(
            next_sample.transcript, next_sample.language
        )
        prompt = prompting.compile_inference_prompt(
            transcript, completion_truth, speech_ids.tolist()
        )
        return {
            "prompt": prompt,
            "prompt_speech_ids": speech_ids,
            "completion_truth": completion_truth,
            "prompt_wav_path": sample.wav_path,
            "language": sample.language,
        }
