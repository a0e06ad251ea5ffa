"""SpeechLM training loop.

Copy of ``tts_max_tpu/training/loop.py`` (the port imports nothing of the
JAX package). Reference parity (tts/training/training_loop.py:172-331):
eval every ``eval_steps`` (including step 0), one optimizer step per
iteration (the step runs all grad-accumulation micro-batches), per-source
statistics, periodic logging, checkpoint + quality-validation every
``save_steps``, non-finite-gradient stop with a final checkpoint, and
fast-forward resume of the data iterator.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import numpy as np

from tts_max_tpu_torch.core.config import ExperimentConfig
from tts_max_tpu_torch.data.collate import prettify_batch
from tts_max_tpu_torch.training import evaluation
from tts_max_tpu_torch.training.checkpointing import CheckpointManager
from tts_max_tpu_torch.utils.logging import get_logger
from tts_max_tpu_torch.utils.statistics import Statistics, Timer, make_process_sum

log = get_logger(__name__)


def _stack_micro_batches(batches: list[dict], accum: int) -> dict:
    """[accum] list of collated micro-batches -> {"input_ids": [A, B, L], ...}.

    Micro-batches in one macro step may land in different buckets; pad to
    the largest so A stacks (rare; costs nothing when buckets agree)."""
    L = max(b["input_ids"].shape[1] for b in batches)

    def pad(x, fill):
        if x.shape[1] == L:
            return x
        out = np.full((x.shape[0], L), fill, dtype=x.dtype)
        out[:, : x.shape[1]] = x
        return out

    return {
        "input_ids": np.stack([pad(b["input_ids"], 0) for b in batches]),
        "labels": np.stack([pad(b["labels"], -100) for b in batches]),
    }


def run(
    *,
    train_step: Callable,
    eval_step: Callable | None,
    params: Any,
    opt_state: Any,
    train_loader,
    val_loader=None,
    config: ExperimentConfig,
    total_training_steps: int,
    steps_per_epoch: int,
    checkpoint_manager: CheckpointManager | None = None,
    quality_validator=None,
    lr_schedule=None,
    metrics_logger: Callable[[int, dict], None] | None = None,
    statistics: Statistics | None = None,
    layout=None,
) -> tuple[Any, Any, Statistics]:
    """Run training; returns (params, opt_state, statistics). ``layout``: the
    ``ShardLayout`` of ``params`` when they are this rank's shards."""
    cfg_t = config.training
    accum = cfg_t.gradient_accumulation_steps
    eval_steps = cfg_t.eval_steps
    logging_steps = cfg_t.logging_steps
    save_steps = config.checkpointing.save_steps
    statistics = statistics or Statistics()
    reduce_fn = make_process_sum()
    # every source any rank can record, so that the ranks reduce the same keys
    train_sources = getattr(train_loader.dataset, "sources", ())
    val_sources = getattr(getattr(val_loader, "dataset", None), "sources", ())

    # ------- resume (reference training_loop.py:26-84) -------
    start_step = statistics.step
    epoch = start_step // max(1, steps_per_epoch)
    batches_to_skip = (start_step % max(1, steps_per_epoch)) * accum
    iterator: Iterator = iter(
        train_loader.batches(epoch, skip_batches=batches_to_skip)
    )
    # consume the fast-forwarded (empty) batches
    for _ in range(batches_to_skip):
        next(iterator, None)

    def next_macro_batch(iterator, epoch):
        micro = []
        while len(micro) < accum:
            try:
                b = next(iterator)
            except StopIteration:
                epoch += 1
                iterator = iter(train_loader.batches(epoch))
                b = next(iterator)
            if b:
                micro.append(b)
        return micro, iterator, epoch

    keep_training = True
    while keep_training:
        # ------- eval (incl. step 0, reference :224-244) -------
        if (
            val_loader is not None
            and eval_step is not None
            and (statistics.step == 0 or statistics.step % eval_steps == 0)
        ):
            metrics = evaluation.compute_metrics(
                eval_step,
                params,
                val_loader.batches(0),
                prettify_batch,
                collect_health_stats=config.checkpointing.collect_health_stats,
                reduce_fn=reduce_fn,
                sources=val_sources,
                layout=layout,
            )
            log.info("Eval step %d: %s", statistics.step, metrics)
            if metrics_logger:
                metrics_logger(statistics.step, metrics)

        # ------- one optimizer step -------
        t0 = time.perf_counter()
        with Timer() as data_t:
            micro, iterator, epoch = next_macro_batch(iterator, epoch)
            macro = _stack_micro_batches(micro, accum)
        statistics.record_data_time(data_t.elapsed)

        params, opt_state, m = train_step(params, opt_state, macro)
        loss = float(m.loss)
        nonfinite = float(m.nonfinite) > 0

        sources = set()
        for b in micro:
            sources.update(b.get("source", []))
            statistics.tokens_processed += int(np.sum(b["tokens_processed"]))
            statistics.audio_processed_sec += float(
                np.sum(b["audio_processed_sec"])
            )
            statistics.samples_processed += len(b["input_ids"])
        statistics.record_loss("total", loss)
        for s in sources:
            statistics.record_loss(s, loss)

        statistics.step += 1
        statistics.epoch = statistics.step / max(1, steps_per_epoch)
        statistics.record_step_time(time.perf_counter() - t0)

        if nonfinite:
            # reference contract: save a final checkpoint and stop
            # (training_loop.py:268-271,308)
            log.error(
                "Non-finite gradients at step %d; saving checkpoint and "
                "stopping.",
                statistics.step,
            )
            keep_training = False

        if statistics.step >= total_training_steps:
            log.info("Maximum number of steps reached. Stopping the training.")
            keep_training = False

        # ------- logging -------
        if statistics.step % logging_steps == 0 or not keep_training:
            stats = statistics.logging_stats(reduce_fn, train_sources)
            if lr_schedule is not None:
                stats["learning_rate"] = float(lr_schedule(statistics.step))
            stats["grad_norm"] = float(m.grad_norm)
            log.info("Training step %d: %s", statistics.step, stats)
            if metrics_logger:
                metrics_logger(statistics.step, stats)
            statistics.reset_window()

        # ------- checkpoint + quality validation -------
        if checkpoint_manager is not None and (
            (save_steps > 0 and statistics.step % save_steps == 0)
            or nonfinite
            or not keep_training
        ):
            with Timer() as t:
                checkpoint_manager.save(
                    statistics.step, params, opt_state, statistics, config
                )
            log.info(
                "Step [%d]: checkpoint took %.2f s.", statistics.step, t.elapsed
            )
            if quality_validator is not None:
                with Timer() as t:
                    quality_validator.validate(params, statistics.step)
                log.info(
                    "Step [%d]: quality validation took %.2f s.",
                    statistics.step,
                    t.elapsed,
                )

    return params, opt_state, statistics
