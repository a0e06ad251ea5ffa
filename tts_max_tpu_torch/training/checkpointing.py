"""Checkpoint save/load/resume (counterpart of ``tts_max_tpu/training/checkpointing.py``).

Torch state dicts take the place of Orbax, with the same contract: a
checkpoint holds {params, opt_state, statistics, config}; the manager keeps
the last N; ``restore`` can load the weights only. A step's checkpoint is
``<dir>/<step>/state.pt`` (tensors, saved from the CPU) beside
``meta.json``, written to a temporary directory first and renamed, so a
directory that exists is complete. Saves are synchronous (Orbax's are
asynchronous; ``wait`` is kept for the same call sites).

The final model is a safetensors file in the port's own format
(``models/safetensors_io.py``), one tensor per parameter leaf under its
"/"-joined path.

Over several ranks (a manager given a ``ShardLayout``), every rank takes
part in gathering the full state leaf by leaf, rank 0 alone keeps each
gathered leaf on the host and writes the state in the same format, and the
others drop each leaf at once and wait at a barrier; ``restore`` reads the
full state on every rank and keeps each rank's shards. A checkpoint is
therefore the same file whatever the world size, and resumes on any.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import torch

from tts_max_tpu_torch.core.config import ExperimentConfig, to_dict
from tts_max_tpu_torch.models import safetensors_io
from tts_max_tpu_torch.parallel.multihost import barrier
from tts_max_tpu_torch.training.optim import tree_items
from tts_max_tpu_torch.utils.statistics import Statistics

CONFIG_FILE_NAME = "training_config.json"
FINAL_MODEL_FILE = "model.safetensors"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _like(template, loaded):
    """``loaded`` moved onto each template leaf's device (dtypes as saved)."""
    if isinstance(template, dict):
        return {k: _like(v, loaded[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_like(v, w) for v, w in zip(template, loaded, strict=True)]
    if torch.is_tensor(template):
        if loaded.shape != template.shape:
            raise ValueError(f"checkpoint leaf {tuple(loaded.shape)} does not match "
                             f"the template's {tuple(template.shape)}")
        return loaded.to(template.device)
    return loaded


class CheckpointManager:
    """Step-numbered checkpoints under ``directory``, the last
    ``keep_last_n`` kept. With ``layout`` (a ``parallel.sharding.ShardLayout``)
    the params and Adam moments handed in are this rank's shards, and
    ``is_main`` says whether this rank writes."""

    def __init__(self, directory: str, keep_last_n: int = 10, async_save: bool = False,
                 layout=None, is_main: bool = True):
        if async_save:
            raise ValueError("the port's checkpoints are written synchronously")
        os.makedirs(directory, exist_ok=True)
        self.directory = os.path.abspath(directory)
        self.keep_last_n = keep_last_n
        self.layout = layout
        self.is_main = is_main
        self.save_seconds: list[float] = []  # of every save, in order

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n, "meta.json")))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Any, opt_state: Any, statistics: Statistics,
             config: ExperimentConfig | None = None) -> None:
        t0 = time.perf_counter()
        if self.layout is not None:  # every rank gathers, rank 0 alone keeps the host copy
            params = self.layout.gather(params, to_cpu=True, keep=self.is_main)
            opt_state = self.layout.gather_opt_state(opt_state, to_cpu=True, keep=self.is_main)
        if self.is_main:
            self._write(step, params, opt_state, statistics, config)
        barrier()  # under a group, the others wait for rank 0's write
        self.save_seconds.append(time.perf_counter() - t0)

    def _write(self, step, params, opt_state, statistics, config) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": _to_cpu(params), "opt_state": _to_cpu(opt_state)},
                   os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"statistics": statistics.state_dict(),
                       "config": to_dict(config) if config else None, "step": step}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.keep_last_n] if self.keep_last_n > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def restore(self, step: int | None, params_template: Any, opt_state_template: Any,
                weights_only: bool = False) -> tuple[Any, Any, Statistics | None]:
        """Restore onto the templates' devices. ``weights_only`` mirrors
        ``only_load_model_weights``: params restored, optimizer state
        and statistics left fresh (the templates and None). With a layout
        the templates are shards: every rank reads the full state and keeps
        its own shards."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        path = os.path.join(self.directory, str(step))
        state = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                           weights_only=True)
        if self.layout is not None:
            state = {"params": self.layout.shard(state["params"]),
                     "opt_state": self.layout.shard_opt_state(state["opt_state"])}
        params = _like(params_template, state["params"])
        if weights_only:
            return params, opt_state_template, None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        opt_state = _like(opt_state_template, state["opt_state"])
        return params, opt_state, Statistics.from_state_dict(meta["statistics"])

    def close(self) -> None:
        """Nothing to release."""


def save_config(output_dir: str, config: ExperimentConfig) -> str:
    """Persist the full config next to the checkpoints."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, CONFIG_FILE_NAME)
    with open(path, "w") as f:
        json.dump(to_dict(config), f, indent=2)
    return path


def save_final_model(output_dir: str, params: Any) -> str:
    """The final weights: ``<output_dir>/final_model/model.safetensors``,
    one tensor per leaf under its "/"-joined path, in its own dtype."""
    path = os.path.join(output_dir, "final_model")
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file({k: v.detach() for k, v in tree_items(params)},
                             os.path.join(path, FINAL_MODEL_FILE))
    return path


def load_final_model(path: str, params_template: Any) -> Any:
    """``save_final_model``'s weights, on each template leaf's device."""
    flat = safetensors_io.load_file(os.path.join(path, FINAL_MODEL_FILE))

    def fill(tmpl, prefix=""):
        if isinstance(tmpl, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in tmpl.items()}
        return flat[prefix[:-1]].to(tmpl.device)

    return fill(params_template)
