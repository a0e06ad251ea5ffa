"""Dataset classes: fine-tuning, pretraining, weighted combination.

Copy of ``tts_max_tpu/data/datasets.py`` (the port imports nothing of the JAX package).

Behavior parity with tts/data/datasets/{finetuning,
pretraining}.py and tts_datasets.py:97-166 (CombinedDataset epoch weighting,
source tagging, fast-forward resume mode), built on numpy (no torch).
"""

from __future__ import annotations

import math
import os
from typing import Any

import numpy as np

from tts_max_tpu_torch.core import constants, prompting
from tts_max_tpu_torch.data.normalization import NoOpTextNormalizer, TextNormalizer


class TtsFineTuningDataset:
    """codes-span + transcript -> tokenized prompt with loss-masked labels
    (reference finetuning.py:13-106)."""

    def __init__(
        self,
        dataset_name: str,
        samples: list,
        codes: np.ndarray,
        indexes: list[tuple[int, int]],
        tokenizer,
        max_seq_len: int,
        text_normalizer: TextNormalizer | None = None,
    ):
        if len(indexes) != len(samples):
            raise ValueError("The number of samples and codes must match!")
        self.dataset_name = dataset_name
        self.samples = samples
        self.codes = codes
        self.indexes = indexes
        self.max_seq_len = max_seq_len
        self.tokenizer = tokenizer
        self.pad_token_id = tokenizer.pad_token_id
        self.speech_start_id = tokenizer.convert_tokens_to_ids(
            constants.SPEECH_START_TOKEN
        )
        self.normalizer = text_normalizer or NoOpTextNormalizer()

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        start, end = self.indexes[idx]
        speech_ids = np.asarray(self.codes[start:end])
        sample = self.samples[idx]
        transcript = self.normalizer.normalize_with_language(
            sample.transcript, sample.language
        )
        prompt = prompting.compile_training_prompt(
            transcript, speech_ids.tolist(), sample.voice_description
        )
        input_ids = np.asarray(
            self.tokenizer.encode(prompt, add_special_tokens=True), dtype=np.int32
        )[: self.max_seq_len]

        sep = np.nonzero(input_ids == self.speech_start_id)[0]
        labels = np.full_like(input_ids, constants.LOSS_IGNORE_TOKEN_ID)
        if len(sep):
            labels[sep[0] :] = input_ids[sep[0] :]
        labels[input_ids == self.pad_token_id] = constants.LOSS_IGNORE_TOKEN_ID

        audio_sec = len(speech_ids) / constants.CODEC_TOKEN_RATE
        return {
            "input_ids": input_ids,
            "labels": labels,
            "tokens_processed": len(input_ids),
            "generated_audio_duration_sec": audio_sec,
            "audio_processed_sec": audio_sec,
        }


class TtsPretrainingDataset:
    """Contiguous max_seq_len windows from a flat pretraining codes memmap
    (reference pretraining.py:15-68). Codes map to token ids through the
    dense SpeechVocab table (no string round-trip)."""

    def __init__(self, dataset_dir: str, split: str, max_seq_len: int, speech_vocab):
        self._codes_path = os.path.join(
            dataset_dir, f"{split}_pretraining_codes.npy"
        )
        self._codes = np.memmap(self._codes_path, dtype=np.int32, mode="r")
        self._max_seq_len = max_seq_len
        if len(self._codes) < max_seq_len:
            raise ValueError(
                f"Dataset [{self._codes_path}] size [{len(self._codes)}] is too "
                f"small for max_seq_len [{max_seq_len}]."
            )
        self._vocab = speech_vocab

    def __len__(self) -> int:
        return len(self._codes) // self._max_seq_len - 1

    def __getitem__(self, idx: int) -> dict[str, Any]:
        i = idx * self._max_seq_len
        codes = np.asarray(self._codes[i : i + self._max_seq_len])
        input_ids = self._vocab.tokens_from_codes(codes).astype(np.int32)
        audio_sec = self._max_seq_len / constants.CODEC_TOKEN_RATE
        return {
            "input_ids": input_ids,
            "labels": input_ids.copy(),
            "tokens_processed": self._max_seq_len,
            "generated_audio_duration_sec": audio_sec,
            "audio_processed_sec": audio_sec,
        }


class TextPretrainingDataset:
    """Pre-tokenized text windows (reference pretraining.py:71-110)."""

    def __init__(self, dataset_dir: str, split: str, max_seq_len: int):
        self._tokens_path = os.path.join(
            dataset_dir, f"{split}_pretraining_tokens.npy"
        )
        self._tokens = np.memmap(self._tokens_path, dtype=np.int32, mode="r")
        self._max_seq_len = max_seq_len
        if len(self._tokens) < max_seq_len:
            raise ValueError(f"Text dataset [{self._tokens_path}] too small.")

    def __len__(self) -> int:
        return len(self._tokens) // self._max_seq_len - 1

    def __getitem__(self, idx: int) -> dict[str, Any]:
        i = idx * self._max_seq_len
        ids = np.asarray(self._tokens[i : i + self._max_seq_len], dtype=np.int32)
        return {
            "input_ids": ids,
            "labels": ids.copy(),
            "tokens_processed": self._max_seq_len,
            "generated_audio_duration_sec": 0.0,
            "audio_processed_sec": 0.0,
        }


def parse_oig_sample(raw_text: str) -> list[dict[str, str]]:
    """OIG "<human>: ... <bot>: ..." text -> chat messages
    (reference finetuning.py:126-149)."""
    messages = []
    raw_text = raw_text.strip()
    if not raw_text.startswith("<human>:"):
        raise ValueError("Sample does not start with <human>:")
    parts = raw_text.split("<human>:")[1:]
    for part in parts:
        if "<bot>:" in part:
            human_text, bot_part = part.split("<bot>:", 1)
            messages.append({"role": "user", "content": human_text.strip()})
            bot_text = bot_part.split("<human>:", 1)[0].strip()
            messages.append({"role": "assistant", "content": bot_text})
        else:
            messages.append({"role": "user", "content": part.strip()})
            break
    return messages


class TextFineTuningDataset:
    """Chat-template text SFT with loss on the final assistant response only
    (reference finetuning.py:109-184). Works with an HF tokenizer
    (apply_chat_template) or any tokenizer via a llama-style template."""

    def __init__(self, records: list, tokenizer, max_seq_len: int):
        self._records = records
        self._tokenizer = tokenizer
        self._max_seq_len = max_seq_len
        self._end_header_id = tokenizer.convert_tokens_to_ids(
            constants.END_HEADER_ID
        )

    def __len__(self) -> int:
        return len(self._records)

    def _messages(self, record) -> list[dict]:
        if isinstance(record, dict) and "messages" in record:
            return record["messages"]
        text = record["text"] if isinstance(record, dict) else record
        return parse_oig_sample(text)

    def _tokenize(self, messages) -> np.ndarray:
        if hasattr(self._tokenizer, "apply_chat_template"):
            try:
                ids = self._tokenizer.apply_chat_template(messages, tokenize=True)
                return np.asarray(ids, dtype=np.int32)
            except Exception:
                pass
        parts = []
        for m in messages:
            parts.append(
                f"<|start_header_id|>{m['role']}{constants.END_HEADER_ID}\n\n"
                f"{m['content']}<|eot_id|>"
            )
        return np.asarray(
            self._tokenizer.encode("".join(parts), add_special_tokens=True),
            dtype=np.int32,
        )

    def __getitem__(self, idx: int) -> dict[str, Any]:
        input_ids = self._tokenize(self._messages(self._records[idx]))
        # mask everything before the last <|end_header_id|> (the final
        # assistant response is the training signal, reference :162-173)
        hits = np.nonzero(input_ids == self._end_header_id)[0]
        response_start = (
            int(hits[-1]) + 1 if len(hits) else len(input_ids) - 1
        )
        response_start = min(response_start, self._max_seq_len - 1)
        input_ids = input_ids[: self._max_seq_len]
        labels = input_ids.copy()
        labels[:response_start] = constants.LOSS_IGNORE_TOKEN_ID
        return {
            "input_ids": input_ids,
            "labels": labels,
            "tokens_processed": len(input_ids),
            "generated_audio_duration_sec": 0.0,
            "audio_processed_sec": 0.0,
        }


class WeightedDataset:
    def __init__(self, name: str, dataset, epochs: float):
        self.name = name
        self.dataset = dataset
        self.epochs = epochs


class CombinedDataset:
    """Virtual concatenation with per-dataset epoch weighting and source
    tagging (reference tts_datasets.py:97-166). Fast-forward mode returns {}
    so resume skips tokenization work."""

    def __init__(self, weighted_datasets: list[WeightedDataset]):
        self._datasets = sorted(weighted_datasets, key=lambda x: x.name)
        self._original_lengths = [len(w.dataset) for w in self._datasets]
        self._effective_lengths = [
            math.floor(len(w.dataset) * w.epochs) for w in self._datasets
        ]
        self._total = sum(self._effective_lengths)
        self._fast_forward = False

    @property
    def sources(self) -> list[str]:
        return [w.name for w in self._datasets]

    def enable_fast_forwarding(self):
        self._fast_forward = True

    def disable_fast_forwarding(self):
        self._fast_forward = False

    def __len__(self) -> int:
        return self._total

    def __getitem__(self, idx: int) -> dict[str, Any]:
        if self._fast_forward:
            return {}
        if idx < 0 or idx >= self._total:
            raise IndexError(f"Index {idx} is out of range.")
        dataset_idx, rel = 0, idx
        while rel >= self._effective_lengths[dataset_idx]:
            rel -= self._effective_lengths[dataset_idx]
            dataset_idx += 1
        rel = rel % self._original_lengths[dataset_idx]
        w = self._datasets[dataset_idx]
        item = w.dataset[rel]
        item["source"] = w.name
        return item
