"""Dataset construction: path → dataset → weighted combination.

Copy of ``tts_max_tpu/data/builder.py`` (the port imports nothing of the JAX package).

Mirrors reference tts_datasets.py:{_build_dataset,merge_datasets}
(225-265): each entry of ``{dataset_path: weight}`` becomes a
WeightedDataset; ``[text]``-suffixed paths select text datasets;
``pretraining_mode`` selects window datasets.
"""

from __future__ import annotations

import os

from tts_max_tpu_torch.core.tokenization import speech_vocab
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.datasets import (
    CombinedDataset,
    TextPretrainingDataset,
    TtsFineTuningDataset,
    TtsPretrainingDataset,
    WeightedDataset,
)
from tts_max_tpu_torch.data.normalization import TextNormalizer


def build_dataset(
    tokenizer,
    dataset_path: str,
    max_seq_len: int,
    split: str,
    pretraining_mode: bool,
    text_normalizer: TextNormalizer,
    dataset_config,
):
    dataset_name = os.path.basename(dataset_path)
    text_dataset = dataset_name.endswith("[text]")
    if pretraining_mode:
        if text_dataset:
            return (
                TextPretrainingDataset(
                    dataset_path.replace("[text]", ""), split, max_seq_len
                ),
                dataset_name,
            )
        return (
            TtsPretrainingDataset(
                dataset_path, split, max_seq_len, speech_vocab(tokenizer)
            ),
            dataset_name,
        )
    codes, samples, indexes, _ = codes_io.load_and_filter_audio_codes_and_samples(
        dataset_path, split, dataset_config
    )
    if dataset_config is not None and getattr(
        dataset_config, "enable_rlhf_training", False
    ):
        from tts_max_tpu_torch.training.rlhf.dataset import TtsRLHFDataset

        return (
            TtsRLHFDataset(
                dataset_name=dataset_name,
                samples=samples,
                codes=codes,
                indexes=indexes,
                tokenizer=tokenizer,
                text_normalizer=text_normalizer,
            ),
            dataset_name,
        )
    return (
        TtsFineTuningDataset(
            dataset_name=dataset_name,
            samples=samples,
            codes=codes,
            indexes=indexes,
            tokenizer=tokenizer,
            max_seq_len=max_seq_len,
            text_normalizer=text_normalizer,
        ),
        dataset_name,
    )


def merge_datasets(
    tokenizer,
    weighted_datasets: dict[str, float],
    max_seq_len: int,
    split: str,
    pretraining_mode: bool,
    text_normalizer: TextNormalizer,
    dataset_config,
) -> CombinedDataset:
    out = []
    for dataset_path, weight in weighted_datasets.items():
        ds, name = build_dataset(
            tokenizer,
            dataset_path,
            max_seq_len,
            split,
            pretraining_mode,
            text_normalizer,
            dataset_config,
        )
        out.append(WeightedDataset(name=name, dataset=ds, epochs=weight))
    return CombinedDataset(out)
