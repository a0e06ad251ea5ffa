"""tts_max_tpu_torch — the PyTorch/CUDA port of tts_max_tpu for NVIDIA Hopper.

Text-to-speech synthesis (voice-prompt wav → codec encoder codes; prompt →
Llama SpeechLM prefill and KV-cached decode → Vocos codec decoder →
waveform), the continuous-batching serving engines, and the serving CLIs
(``tools/``: single shot, JSONL batch, HTTP with streaming) over an HF
checkpoint directory, with hand-written CUDA kernels for prefill, decode,
ragged decode and paged decode attention and the codec encoder's
anti-aliased SnakeBeta (``csrc/``). The JAX package ``tts_max_tpu`` is the
reference this package is tested against; this package imports nothing of
it and nothing of JAX.
"""
