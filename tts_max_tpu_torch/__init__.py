"""tts_max_tpu_torch — the PyTorch/CUDA port of tts_max_tpu for NVIDIA Hopper.

Text-to-speech synthesis (prompt → Llama SpeechLM prefill and KV-cached
decode → Vocos codec decoder → waveform) with hand-written CUDA kernels for
prefill and decode attention (``csrc/``). The JAX package ``tts_max_tpu``
is the reference this package is tested against; this package imports
nothing of it and nothing of JAX.
"""
