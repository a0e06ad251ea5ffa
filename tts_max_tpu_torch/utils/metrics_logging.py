"""Experiment metrics logging: W&B when available, JSONL always.

Copy of ``tts_max_tpu/utils/metrics_logging.py`` (the port imports nothing of the JAX package).

Reference parity (tts/utils/configuration.py:308-341 wandb
init, custom_logging.py:208-222 ``train_`` → ``train/`` key rewrite,
training_loop.py:237-241,299-303 logging sites). wandb is optional (not in
the TPU image); the JSONL sink gives the same record stream for offline
plotting/loss-curve comparison.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def rewrite_logs_for_wandb(metrics: dict[str, Any]) -> dict[str, Any]:
    """``train_x`` → ``train/x``, ``val_x`` → ``val/x``
    (reference custom_logging.py:208-222)."""
    out = {}
    for k, v in metrics.items():
        for prefix in ("train_", "val_", "eval_"):
            if k.startswith(prefix):
                k = prefix[:-1] + "/" + k[len(prefix):]
                break
        out[k] = v
    return out


class MetricsLogger:
    """Fan-out logger: JSONL file + optional wandb run (process 0 only)."""

    def __init__(
        self,
        output_dir: str,
        experiment_name: str = "experiment",
        use_wandb: bool = False,
        wandb_project: str = "tts-max-tpu",
        config: dict | None = None,
        is_main: bool = True,
    ):
        self._is_main = is_main
        self._jsonl = None
        self._wandb = None
        if not is_main:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(
            os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1
        )
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_project, name=experiment_name, config=config
                )
            except Exception:
                self._wandb = None

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        if not self._is_main:
            return
        record = {"step": step, "time": time.time(), **rewrite_logs_for_wandb(metrics)}
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(rewrite_logs_for_wandb(metrics), step=step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __call__(self, step: int, metrics: dict[str, Any]) -> None:
        self.log(step, metrics)
