"""DNSMOS speech-quality scoring over ONNX weights (counterpart of
``tts_max_tpu/training/rlhf/dnsmos.py``).

The reward's published weights exist only as ONNX graphs
(``sig_bak_ovr.onnx`` and ``model_v8.onnx`` from the Microsoft
DNS-Challenge); the port executes them with its own interpreter
(``utils/onnx_lite.py``, torch ops on the card) inside the DNS-Challenge
pipeline:

- 9.01 s segments hopping 1 s (the clip repeated until it fills one);
- primary model input = the raw 16 kHz segment [1, 144160];
- P.808 model input = log-power mel (n_fft 321, hop 160, 120 mels,
  ``(power_to_db(ref=max) + 40) / 40``) of the segment minus its last hop;
- each segment's raw scores through the published polynomial fits
  (personalized or not), averaged over segments.

The mel features are computed on the scorer's device and finished in
float64 numpy on the host, as the JAX module finishes them. ``DNSMOS``
counts its calls (``calls``) and the calls that returned a score
(``completed``), so that a caller can tell a score from the reward's
default.
"""

from __future__ import annotations

import math
import os
from typing import Callable

import numpy as np
import torch
from scipy.signal import resample_poly

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.ops import stft as stft_ops
from tts_max_tpu_torch.utils import onnx_lite

SAMPLE_RATE = 16000
INPUT_LENGTH_S = 9.01
SEGMENT_SAMPLES = int(INPUT_LENGTH_S * SAMPLE_RATE)  # 144160

# np.poly1d coefficient vectors from the DNS-Challenge dnsmos_local.py
# (highest power first).
_POLY = {
    False: {
        "ovr": [-0.06766283, 1.11546468, 0.04602535],
        "sig": [-0.08397278, 1.22083953, 0.0052439],
        "bak": [-0.13166888, 1.60915514, -0.39604546],
    },
    True: {
        "ovr": [-0.00533021, 0.005101, 1.18058466, -0.11236046],
        "sig": [-0.01019296, 0.02751166, 1.19576786, -0.24348726],
        "bak": [-0.04976499, 0.44276479, -0.1644611, 0.96883132],
    },
}


@torch.inference_mode()
def audio_melspec(audio: np.ndarray, device="cuda") -> np.ndarray:
    """DNS-Challenge mel features: librosa.feature.melspectrogram(n_fft=321,
    hop=160, n_mels=120, power=2, center=True, pad zeros), then
    ``(power_to_db(ref=max) + 40) / 40``. audio: [n] -> [T, 120]."""
    n_fft, hop, n_mels = 321, 160, 120
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(audio, dtype=np.float32), device=dev)[None]
    spec = stft_ops.stft(x, n_fft, hop, center=True, pad_mode="constant")  # [1, F, T]
    power = spec.abs().cpu().numpy() ** 2
    fb = stft_ops.mel_filterbank(SAMPLE_RATE, n_fft, n_mels)  # [F, n_mels]
    mel = np.einsum("ft,fm->mt", power[0], fb)  # [n_mels, T]
    # librosa.power_to_db(ref=np.max, amin=1e-10, top_db=80)
    ref = max(mel.max(), 1e-10)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10)) - 10.0 * np.log10(ref)
    db = np.maximum(db, db.max() - 80.0)
    return ((db + 40.0) / 40.0).T.astype(np.float32)  # [T, n_mels]


def _poly(coeffs, x):
    y = 0.0
    for c in coeffs:
        y = y * x + c
    return y


class DNSMOS:
    """``dnsmos(audio [n], sample_rate) -> mos_ovr`` (``.score`` gives all
    four numbers: p808, sig, bak, ovr), the graphs run on ``device``."""

    def __init__(
        self,
        primary_graph: onnx_lite.Graph | None,
        p808_graph: onnx_lite.Graph | None,
        personalized: bool = True,
        device="cuda",
    ):
        if primary_graph is None and p808_graph is None:
            raise ValueError("need at least one DNSMOS ONNX graph")
        self.device = resolve_device(device)
        self._primary = primary_graph
        self._p808 = p808_graph
        self._personalized = personalized
        self.calls = 0
        self.completed = 0

    @torch.inference_mode()
    def score(self, audio: np.ndarray, sample_rate: int) -> dict[str, float]:
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        if sample_rate != SAMPLE_RATE:
            g = math.gcd(int(sample_rate), SAMPLE_RATE)
            audio = resample_poly(audio, SAMPLE_RATE // g, sample_rate // g)
            audio = audio.astype(np.float32)
        while audio.shape[0] < SEGMENT_SAMPLES:
            audio = np.concatenate([audio, audio])
        num_hops = int(np.floor(audio.shape[0] / SAMPLE_RATE) - INPUT_LENGTH_S) + 1
        per_seg: list[dict[str, float]] = []
        for idx in range(max(num_hops, 1)):
            seg = audio[idx * SAMPLE_RATE : idx * SAMPLE_RATE + SEGMENT_SAMPLES]
            if seg.shape[0] < SEGMENT_SAMPLES:
                continue
            rec: dict[str, float] = {}
            if self._p808 is not None:
                feats = audio_melspec(seg[:-160], self.device)[None]  # [1, T, 120]
                (p808_out,) = onnx_lite.run(
                    self._p808, {self._p808.feed_names[0]: feats}, self.device
                )
                rec["p808"] = float(p808_out.reshape(-1)[0])
            if self._primary is not None:
                (raw,) = onnx_lite.run(
                    self._primary, {self._primary.feed_names[0]: seg[None]}, self.device
                )
                sig_r, bak_r, ovr_r = onnx_lite._np(raw).reshape(-1)[:3]
                p = _POLY[self._personalized]
                rec["sig"] = float(_poly(p["sig"], sig_r))
                rec["bak"] = float(_poly(p["bak"], bak_r))
                rec["ovr"] = float(_poly(p["ovr"], ovr_r))
            per_seg.append(rec)
        keys = per_seg[0].keys()
        return {k: float(np.mean([r[k] for r in per_seg])) for k in keys}

    def __call__(self, audio: np.ndarray, sample_rate: int) -> float:
        self.calls += 1
        s = self.score(audio, sample_rate)
        # the reference consumes mos_ovr; p808 when only the P.808 model is there
        out = s.get("ovr", s.get("p808", 1.0))
        self.completed += 1
        return out


def load_dnsmos(
    primary_path: str | None = None,
    p808_path: str | None = None,
    personalized: bool = True,
    device="cuda",
) -> Callable[[np.ndarray, int], float]:
    """A ``dnsmos_fn`` from local ONNX files. With no explicit paths, looks
    in ``$DNSMOS_ONNX_DIR`` for ``sig_bak_ovr.onnx`` / ``model_v8.onnx``."""
    if primary_path is None and p808_path is None:
        d = os.environ.get("DNSMOS_ONNX_DIR", "")
        if d:
            cand = os.path.join(d, "sig_bak_ovr.onnx")
            primary_path = cand if os.path.exists(cand) else None
            cand = os.path.join(d, "model_v8.onnx")
            p808_path = cand if os.path.exists(cand) else None
    primary = onnx_lite.load_model(primary_path) if primary_path else None
    p808 = onnx_lite.load_model(p808_path) if p808_path else None
    return DNSMOS(primary, p808, personalized=personalized, device=device)
