"""Single-shot synthesis CLI (counterpart of ``tools/serving_inference.py``).

Loads an HF-format serving directory (safetensors or ``.bin`` shards and
``config.json``), or a pre-quantized one (``models/hf_import.save_quantized_dir``),
and codec checkpoints, and synthesizes text into a 16 kHz
wav through ``LocalTtsModel``. Without codec checkpoints it runs in smoke
mode: a seeded tiny Vocos decoder and a seeded tiny codec encoder (with an
all-zero semantic stream), as the JAX CLI does.

Runs on the card unless ``--device cpu`` is given:

  python -m tts_max_tpu_torch.tools.serving_inference --model_dir serving \\
      --text "Hello world" --output out.wav \\
      [--prompt_wav voice.wav --prompt_transcript "..."] [--voice_description "..."] \\
      [--codec_decoder dec.pt --codec_encoder enc.pt] [--max_tokens 1792] \\
      [--temperature 0.8] [--seed 42] [--dtype bfloat16] [--device cuda] \\
      [--quantize [int8|int4|int4-g64|int4-g128]]

``--quantize`` (bare: ``int8``) quantizes the weights at load, weight-only:
the dir's weights are read in fp32 and quantized on the device, leaf by
leaf (``models/quantization.quantize_for_serving``); the layer products of
a decode step then run the kernel of ``ops/quant_matmul.py``. A
pre-quantized dir is served as it is, and ``--quantize`` is then ignored
with a warning.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from tts_max_tpu_torch.core.constants import CODEC_SAMPLE_RATE
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, speech_vocab
from tts_max_tpu_torch.data.audio_io import load_wav, save_wav
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.inference.synthesize import InferenceSettings, LocalTtsModel
from tts_max_tpu_torch.models import hf_import, quantization
from tts_max_tpu_torch.models.codec import api, encoder as enc, vocos
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("serving")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The flags every serving CLI of the port shares: the model directory,
    the codec checkpoints, weight-only quantization, the compute dtype and
    the device."""
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--codec_decoder", default="")
    parser.add_argument("--codec_encoder", default="")
    parser.add_argument("--quantize", nargs="?", const="int8", default="",
                        choices=["", "int8", "int4", "int4-g64", "int4-g128"],
                        help="weight-only quantization of the SpeechLM: int8, int4 "
                             "(per channel) or int4 in 64- or 128-row groups")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                        help="compute dtype of the SpeechLM (the JAX package's is bf16)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default: the card) or 'cpu' (plain versions "
                             "of the kernels, for tests)")


def load_model(args):
    """(params, cfg, seconds) of the serving dir ``args.model_dir`` on
    ``args.device`` in ``args.dtype``, quantized as ``args.quantize`` asks
    (weights read in fp32, as the JAX package imports them, then quantized
    on the device); a pre-quantized dir is served as it is."""
    t0 = time.perf_counter()
    if args.quantize and hf_import.is_quantized_dir(args.model_dir):
        log.warning("model dir is pre-quantized; ignoring --quantize")
        args.quantize = ""
    dtype = DTYPES[args.dtype]
    params, cfg = hf_import.load_serving_model(
        args.model_dir, device=args.device, dtype=torch.float32 if args.quantize else dtype)
    if args.quantize:
        params = quantization.quantize_for_serving(params, args.quantize)
        cfg = dataclasses.replace(cfg, dtype=dtype)
        log.info("Quantized weights (%s).", args.quantize)
    if resolve_device(args.device).type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log.info("Loaded model from %s in %.2fs (vocab %d, %d layers, %s on %s)",
             args.model_dir, load_s, cfg.vocab_size, cfg.n_layers, args.dtype, args.device)
    return params, cfg, load_s


def build_codec(args):
    """(CachingAudioEncoder, AudioDecoder) on ``args.device``: from the
    checkpoints when given, else seeded tiny ones (smoke mode)."""
    dev = resolve_device(args.device)
    if args.codec_decoder:
        decoder = api.create_decoder(args.codec_decoder, device=dev)
    else:
        cfg = vocos.tiny_vocos_config()
        decoder = api.AudioDecoder(vocos.init_decoder(cfg, seed=1, device=dev), cfg,
                                   api.DecoderConfig(), device=dev)
        log.warning("No decoder checkpoint: random decoder (smoke mode).")
    if args.codec_encoder:
        encoder = api.create_encoder(args.codec_encoder, device=dev)
    else:
        cfg = enc.tiny_encoder_config()

        def zero_semantic(w: np.ndarray) -> torch.Tensor:
            return torch.zeros((w.shape[0], w.shape[1] // cfg.hop_length,
                                cfg.semantic_input_dim), device=dev)

        encoder = api.AudioEncoder(enc.init_encoder(cfg, seed=2, device=dev), cfg,
                                   zero_semantic, device=dev)
        log.warning("No encoder checkpoint: random encoder (smoke mode).")
    return api.CachingAudioEncoder(encoder), decoder


def main(argv=None) -> dict:
    """Synthesize one request; returns {"result": InferenceResult,
    "load_s": seconds to load the serving dir}."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    add_model_args(parser)
    parser.add_argument("--text", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--prompt_wav", default="")
    parser.add_argument("--prompt_transcript", default="")
    parser.add_argument("--voice_description", default="")
    parser.add_argument("--max_tokens", type=int, default=1792)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    setup_logging(0)

    tokenizer = build_byte_tokenizer()
    sv = speech_vocab(tokenizer)
    params, cfg, load_s = load_model(args)
    encoder, decoder = build_codec(args)
    model = LocalTtsModel(params, cfg, tokenizer, sv, encoder, decoder, device=args.device)

    if args.prompt_wav:
        prompt_wav = load_wav(args.prompt_wav, CODEC_SAMPLE_RATE)[0][0]
    else:
        prompt_wav = np.zeros(CODEC_SAMPLE_RATE, dtype=np.float32)
    settings = InferenceSettings(max_tokens=args.max_tokens, temperature=args.temperature,
                                 seed=args.seed)
    res = model.synthesize_speech(
        settings,
        text_to_synthesize=args.text,
        prompt_id=args.prompt_wav or "silence",
        prompt_wav=prompt_wav,
        audio_prompt_transcription=args.prompt_transcript,
        voice_description=args.voice_description,
    )
    save_wav(args.output, res.wav, decoder.sample_rate)
    log.info("Wrote %s: %.2fs audio (encode %.2fs, generate %.2fs, decode %.2fs)",
             args.output, res.wav.shape[1] / decoder.sample_rate, res.encoding_time,
             res.inference_time, res.decoding_time)
    return {"result": res, "load_s": load_s}


if __name__ == "__main__":
    main()
