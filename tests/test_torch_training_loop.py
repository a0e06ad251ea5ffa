"""The port's training loop, checkpoints and final model
(``tts_max_tpu_torch/training``), mirroring ``tests/test_training_loop.py``,
and the slice as a whole: JAX's ``loop.run`` and the port's from the same
weights over the same loader (accumulation 2, eval on), step by step.

Tolerances: per-step losses and eval losses rtol 1e-5 (fp32 on both, other
sum orders); final params atol 5e-6 after five AdamW steps at lr <= 1e-3
(each step's update moves by ~lr x the relative grad error, 1e-4 at most,
so five steps stay near 5e-7; 5e-6 leaves room for the smallest grads). A
resumed run must equal the uninterrupted one exactly (same program, same
batches).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.core.config import ExperimentConfig as JExperimentConfig
from tts_max_tpu.core.config import from_dict as jfrom_dict
from tts_max_tpu.data.collate import collate as jcollate
from tts_max_tpu.data.loader import DataLoader as JDataLoader
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.training import loop as jloop
from tts_max_tpu.training import optim as joptim
from tts_max_tpu.training import train_step as jts
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core.config import ExperimentConfig, from_dict
from tts_max_tpu_torch.data.collate import collate
from tts_max_tpu_torch.data.loader import DataLoader
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.training import loop, optim, train_step as ts
from tts_max_tpu_torch.training.checkpointing import (
    CheckpointManager,
    load_final_model,
    save_config,
    save_final_model,
)
from tts_max_tpu_torch.utils.statistics import Statistics


class SyntheticDataset:
    """Deterministic fake LM data (numpy: the same items for both packages)."""

    def __init__(self, n=64, L=24, vocab=128):
        self.n, self.L, self.vocab = n, L, vocab

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        ids = rng.integers(3, self.vocab, self.L).astype(np.int32)
        labels = ids.copy()
        labels[:4] = -100
        return {"input_ids": ids, "labels": labels, "tokens_processed": self.L,
                "audio_processed_sec": self.L / 50, "source": "synt"}


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.tiny_config(vocab_size=128, max_seq_len=64),
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(llama.tiny_config(vocab_size=128, max_seq_len=64),
                               dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                      device="cpu")
    return jcfg, pcfg, jparams, params


def _loader(mod_loader=DataLoader, mod_collate=collate, batch=4):
    return mod_loader(SyntheticDataset(), batch,
                      functools.partial(mod_collate, pad_token_id=0, max_seq_len=64),
                      shuffle=True, seed=0)


_CFG = {"training": {"logging_steps": 5, "eval_steps": 3, "gradient_accumulation_steps": 2},
        "modeling": {}, "checkpointing": {"save_steps": 5}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if torch.is_tensor(v) else v,
                                             dtype=np.float32)
    return out


def test_checkpoint_roundtrip_and_weights_only(tmp_path, tiny):
    _, _, _, params = tiny
    tx = optim.create_optimizer(1e-3)
    opt_state = tx.init(params)
    opt_state["mu"]["norm"]["scale"] += 0.5
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2)
    stats = Statistics()
    stats.step = 3
    stats.record_loss("synt", 1.5)
    mgr.save(3, params, opt_state, stats)
    mgr.wait()
    assert mgr.latest_step() == 3
    p2, o2, s2 = mgr.restore(None, params, tx.init(params))
    assert s2.step == 3 and s2.loss_sums["synt"] == 1.5 and o2["count"] == 0
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(p2)[k], v)
    np.testing.assert_array_equal(o2["mu"]["norm"]["scale"], opt_state["mu"]["norm"]["scale"])
    fresh = tx.init(params)
    p3, o3, s3 = mgr.restore(3, params, fresh, weights_only=True)
    assert s3 is None and o3 is fresh
    mgr.close()


def test_checkpoint_pruning(tmp_path, tiny):
    _, _, _, params = tiny
    tx = optim.create_optimizer(1e-3)
    mgr = CheckpointManager(str(tmp_path / "ck2"), keep_last_n=2)
    for step in (1, 2, 3):
        s = Statistics()
        s.step = step
        mgr.save(step, params, tx.init(params), s)
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    assert len(mgr.save_seconds) == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, params, {})


def test_final_model_and_config_roundtrip(tmp_path, tiny):
    _, _, _, params = tiny
    path = save_final_model(str(tmp_path / "out"), params)
    p2 = load_final_model(path, params)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(p2)[k], v)
    cfg_path = save_config(str(tmp_path / "out"), from_dict(ExperimentConfig, _CFG))
    assert ExperimentConfig.from_json(cfg_path).training.eval_steps == 3


def _recording(step_fn, losses):
    def run(p, o, b):
        p, o, m = step_fn(p, o, b)
        losses.append(float(m.loss))
        return p, o, m
    return run


def test_loop_matches_jax_loop(tmp_path, tiny):
    """The slice as a whole: six steps of accumulation 2 (batch 4) with eval
    at steps 0, 3 and 6, a cosine schedule with warmup, checkpoints; the
    port's loop against JAX's, from the same weights and batches."""
    jcfg, pcfg, jparams, params = tiny
    jsched = joptim.cosine_warmup_schedule(1e-3, 2, 6)
    jtx = joptim.create_optimizer(jsched)
    sched = optim.cosine_warmup_schedule(1e-3, 2, 6)
    tx = optim.create_optimizer(sched)
    jlogged, logged, jlosses, losses = {}, {}, [], []
    jp, _, jstats = jloop.run(
        train_step=_recording(jax.jit(functools.partial(jts.train_step, cfg=jcfg, tx=jtx)),
                              jlosses),
        eval_step=jax.jit(functools.partial(jts.eval_step, cfg=jcfg)),
        params=jparams, opt_state=jtx.init(jparams),
        train_loader=_loader(JDataLoader, jcollate), val_loader=_loader(JDataLoader, jcollate),
        config=jfrom_dict(JExperimentConfig, _CFG), total_training_steps=6, steps_per_epoch=8,
        lr_schedule=jsched, metrics_logger=lambda s, m: jlogged.setdefault(s, []).append(m))
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2)
    p, _, stats = loop.run(
        train_step=_recording(functools.partial(ts.train_step, cfg=pcfg, tx=tx), losses),
        eval_step=functools.partial(ts.eval_step, cfg=pcfg),
        params=params, opt_state=tx.init(params),
        train_loader=_loader(), val_loader=_loader(),
        config=from_dict(ExperimentConfig, _CFG), total_training_steps=6, steps_per_epoch=8,
        checkpoint_manager=mgr, lr_schedule=sched,
        metrics_logger=lambda s, m: logged.setdefault(s, []).append(m))
    assert stats.step == jstats.step == 6 and mgr.all_steps() == [5, 6]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert sorted(logged) == sorted(jlogged)
    for step in jlogged:
        for m, jm in zip(logged[step], jlogged[step]):
            for k in jm:
                if k.startswith(("val_loss/", "loss/", "grad_norm", "learning_rate")):
                    np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=f"{step} {k}")
    assert "val_loss/total" in logged[0][0] and "val_loss/total" in logged[3][0]
    for k, v in _flat(jp).items():
        np.testing.assert_allclose(_flat(p)[k], v, rtol=0, atol=5e-6, err_msg=k)


def test_resume_equals_uninterrupted_run(tmp_path, tiny):
    _, pcfg, _, params = tiny
    sched = optim.cosine_warmup_schedule(1e-3, 1, 6)
    tx = optim.create_optimizer(sched)
    step_fn = functools.partial(ts.train_step, cfg=pcfg, tx=tx)
    config = from_dict(ExperimentConfig, _CFG)
    kw = dict(train_step=step_fn, eval_step=None, train_loader=_loader(), config=config,
              steps_per_epoch=8)
    p_full, o_full, _ = loop.run(params=params, opt_state=tx.init(params),
                                 total_training_steps=6, **kw)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=1)
    loop.run(params=params, opt_state=tx.init(params), total_training_steps=5,
             checkpoint_manager=mgr, **kw)
    p2, o2, s2 = mgr.restore(None, params, tx.init(params))
    assert s2.step == 5
    p3, o3, s3 = loop.run(params=p2, opt_state=o2, total_training_steps=6, statistics=s2, **kw)
    assert s3.step == 6 and o3["count"] == o_full["count"] == 6
    for k, v in _flat(p_full).items():
        np.testing.assert_array_equal(_flat(p3)[k], v, err_msg=k)
