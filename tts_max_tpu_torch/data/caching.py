"""HF cache directory helper (reference tts/data/caching.py:6-9); a copy of
``tts_max_tpu/data/caching.py`` (the port imports nothing of the JAX package)."""

from __future__ import annotations

import os


def get_hf_cache_dir() -> str:
    """Repo-local HF cache (keeps model downloads next to the checkout)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(repo_root, "hf_cache")
    os.makedirs(path, exist_ok=True)
    return path
