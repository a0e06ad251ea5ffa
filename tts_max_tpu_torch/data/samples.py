"""TTS sample metadata (jsonl records).

Copy of ``tts_max_tpu/data/samples.py`` (the port imports nothing of the JAX package).

Field/default parity with the reference Sample dataclass
(tts/data/data_sample.py:15-94) so datasets interchange.
"""

from __future__ import annotations

import dataclasses
import json
import uuid
from typing import Any

_DEFAULTS = {
    "speaker_id": "",
    "emotion": "",
    "language": "unknown",
    "dnsmos_mos_ovr": 0.0,
    "style": "",
}


@dataclasses.dataclass
class Sample:
    id: str
    wav_path: str
    speaker_id: str
    language: str
    emotion: str
    transcript: str
    voice_description: str
    sound_effect: str
    duration: float
    sample_rate: int
    dataset_name: str
    dnsmos_mos_ovr: float
    style: str
    original_data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.transcript and not self.voice_description and not self.sound_effect:
            raise ValueError(
                "At least one of transcript, voice_description, or sound_effect "
                "must be set."
            )

    def to_json(self) -> dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v}

    @classmethod
    def from_json(cls, data: dict[str, Any], dataset_name: str) -> "Sample":
        if not dataset_name:
            raise ValueError("dataset_name is required")
        if data.get("wav_path") is None:
            raise ValueError(f"wav_path is required for sample: {data}")
        return cls(
            id=data.get("id", str(uuid.uuid4())),
            wav_path=data["wav_path"],
            speaker_id=data.get("speaker_id", _DEFAULTS["speaker_id"]),
            emotion=data.get("emotion", _DEFAULTS["emotion"]).lower(),
            transcript=data.get("transcript", ""),
            voice_description=data.get("voice_description", ""),
            sound_effect=data.get("sound_effect", ""),
            language=data.get("language", _DEFAULTS["language"]),
            duration=data.get("duration", -1.0),
            sample_rate=data.get("sample_rate", -1),
            dataset_name=dataset_name,
            dnsmos_mos_ovr=data.get("dnsmos_mos_ovr", _DEFAULTS["dnsmos_mos_ovr"]),
            style=data.get("style", _DEFAULTS["style"]).lower(),
            original_data=data.get("original_data", {}),
        )


def read_samples_jsonl(path: str, dataset_name: str) -> list[Sample]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Sample.from_json(json.loads(line), dataset_name))
    return out


def write_samples_jsonl(path: str, samples: list[Sample]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for s in samples:
            f.write(json.dumps(s.to_json(), ensure_ascii=False) + "\n")
