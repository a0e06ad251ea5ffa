"""Training output -> HF-format serving directory (counterpart of
``tools/convert_checkpoint.py``): the contract between the trainer and the
serving CLIs.

Reads the trainer's final model (``<dir>/final_model/model.safetensors``,
``training/checkpointing.save_final_model``) in fp32, as the JAX tool
restores it; optionally merges a LoRA adapter (``models/lora.py``) and adds
the nonverbal tokens with the vocab rounded up to a multiple of 64
(``hf_import.resize_embeddings``); sets eos to <|speech_end|>; writes an HF
dir (``hf_import.save_model_to_hf_dir``, fp32 tensors) and, with
``--quantize``, a pre-quantized serving dir beside it
(``<output_dir>/quantized-<mode>``, ``hf_import.save_quantized_dir``).

  python -m tts_max_tpu_torch.tools.convert_checkpoint --checkpoint_dir out \\
      --output_dir serving [--architecture llama-3.2-1b] [--vocab_size N] \\
      [--add_nonverbal] [--lora_adapter adapter.npz --lora_r 16 --lora_alpha 32] \\
      [--quantize [int8|int4|int4-g64|int4-g128]] [--device cuda]

``--add_nonverbal`` resizes the vocab to ``round_up(len(tokenizer), 64)``
whatever ``--vocab_size`` was, as the JAX tool does: on a model trained at
the fixed 193856-token vocab with the byte tokenizer it cuts the embedding
to 65856 rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from tts_max_tpu_torch.core import constants
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models import hf_import, llama, lora, quantization
from tts_max_tpu_torch.training.checkpointing import load_final_model
from tts_max_tpu_torch.training.optim import tree_items, tree_map
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("convert")


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def main(argv=None) -> tuple:
    """Returns (the merged fp32 params as written, their config)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True,
                        help="a final_model dir, or the training output dir above it")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--architecture", default="llama-tiny")
    parser.add_argument("--vocab_size", type=int, default=0)
    parser.add_argument("--add_nonverbal", action="store_true")
    parser.add_argument("--lora_adapter", default="")
    parser.add_argument("--lora_r", type=int, default=16)
    parser.add_argument("--lora_alpha", type=int, default=32)
    parser.add_argument("--quantize", nargs="?", const="int8", default="",
                        choices=["", "int8", "int4", "int4-g64", "int4-g128"],
                        help="also write a pre-quantized serving dir "
                             "(<output_dir>/quantized-<mode>)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    setup_logging(0)
    device = resolve_device(args.device)

    tokenizer = build_byte_tokenizer()
    vocab = args.vocab_size or len(tokenizer)
    cfg = dataclasses.replace(llama.config_for_architecture(args.architecture,
                                                            vocab_size=vocab),
                              dtype=torch.float32)
    path = args.checkpoint_dir
    if os.path.isdir(os.path.join(path, "final_model")):
        path = os.path.join(path, "final_model")
    template = llama.init_params(cfg, seed=0, device=device)
    params = tree_map(lambda t: t.float(), load_final_model(path, template))
    for (name, got), (_, want) in zip(tree_items(params), tree_items(template)):
        if got.shape != want.shape:
            raise ValueError(f"{name}: {tuple(got.shape)} in {path}, {tuple(want.shape)} "
                             f"for {args.architecture} at vocab {vocab}")
    del template
    log.info("Loaded %d params from %s", llama.param_count(params), path)

    if args.lora_adapter:
        adapter = lora.load_adapter(args.lora_adapter,
                                    lora.init_lora(params, r=args.lora_r))
        with torch.no_grad():
            params = lora.merge(params, adapter, args.lora_alpha, args.lora_r)
        log.info("Merged LoRA adapter from %s", args.lora_adapter)

    if args.add_nonverbal:
        tokenizer.add_tokens(constants.NONVERBAL_TOKENS)
        new_vocab = round_up(len(tokenizer), 64)
        params, cfg = hf_import.resize_embeddings(params, cfg, new_vocab)
        log.info("Vocab resized from %d to %d (+nonverbal, x64 rounded)", vocab, new_vocab)

    eos_id = int(tokenizer.convert_tokens_to_ids(constants.SPEECH_END_TOKEN))
    hf_import.save_model_to_hf_dir(params, cfg, args.output_dir, eos_token_id=eos_id)
    log.info("Serving model written to %s (eos=%d)", args.output_dir, eos_id)

    if args.quantize:
        bits = 4 if args.quantize.startswith("int4") else 8
        qdir = os.path.join(args.output_dir, f"quantized-{args.quantize}")
        # quantize_for_serving replaces the leaves of the dicts it is given
        qparams = quantization.quantize_for_serving(tree_map(lambda t: t, params),
                                                    args.quantize)
        hf_import.save_quantized_dir(qparams, cfg, qdir, bits)
        del qparams
        log.info("Quantized serving dir written to %s", qdir)
    return params, cfg


if __name__ == "__main__":
    main()
