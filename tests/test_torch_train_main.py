"""The port's SFT entry point, ``python -m tts_max_tpu_torch.training.main``,
on the CPU: a tiny from-scratch config (the byte tokenizer, ``llama-tiny``)
over a dataset written with the port's ``codes_io.write_shard``. Three steps
write finite losses to the metrics log, the config, a checkpoint and the
final model; ``--dry_run`` takes one step and writes nothing; a rerun with a
higher ``--total_steps`` resumes from the checkpoint and continues the step
count; what is not ported yet (tensor parallelism) raises. An HF directory as ``model_name``
(a tiny Llama written by JAX's ``save_model_to_hf_dir`` beside the
Llama-3-style fixture tokenizer) builds the same tokenizer, params and
dataset ids as JAX's ``build_model_and_tokenizer``, and one fp32 step on the
first batch gives JAX's loss within the train-step tests' rtol 1e-5."""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tts_max_tpu_torch.core.config import ExperimentConfig
from tts_max_tpu_torch.data import builder, codes_io
from tts_max_tpu_torch.data.collate import collate
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.training import main as train_main
from tts_max_tpu_torch.training import optim, train_step as ts

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "llama3_style_tokenizer")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(path):
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 4)):
        lens = rng.integers(20, 40, n)
        codes = rng.integers(0, 65536, int(lens.sum())).astype(np.int32)
        index = np.concatenate([[0], np.cumsum(lens)[:-1]])
        samples = [Sample.from_json({"id": f"{split}{i}", "wav_path": f"{split}{i}.wav",
                                     "transcript": f"hello number {i}", "language": "en",
                                     "duration": 0.6, "sample_rate": 16000}, "tiny")
                   for i in range(n)]
        codes_io.write_shard(path, split, codes, index, samples)


def _config(tmp_path, **checkpointing):
    data = str(tmp_path / "tiny")
    _dataset(data)
    cfg = {"training": {"batch_size": 2, "logging_steps": 1, "eval_steps": 2, "seed": 1,
                        "precision": "fp32", "gradient_checkpointing": True,
                        "loss_chunk_size": 16},
           "modeling": {"parameters": {"model_name": "from-scratch",
                                       "architecture": "llama-tiny", "max_seq_len": 128}},
           "checkpointing": {"save_steps": 2, "keep_only_last_n_checkpoints": 2,
                             **checkpointing},
           "train_weighted_datasets": {data: 1.0}, "val_weighted_datasets": {data: 1.0},
           "output_dir": str(tmp_path / "out")}
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


def _run(path, *extra):
    return train_main.main(["--config_path", path, "--device", "cpu", *extra])


def test_train_writes_outputs_and_resumes(tmp_path):
    path, cfg = _config(tmp_path)
    res = _run(path, "--total_steps", "3")
    out = cfg["output_dir"]
    assert [s for s, _, _, _ in res.steps] == [1, 2, 3] and res.statistics.step == 3
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss/total"] for r in records if "loss/total" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert any("val/loss/total" in r for r in records)  # val_ rewritten as val/
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2", "3"]
    assert os.path.isfile(os.path.join(out, "final_model", "model.safetensors"))
    with open(os.path.join(out, "training_config.json")) as f:
        assert json.load(f)["training"]["batch_size"] == 2
    assert len(res.checkpoint_seconds) == 2

    res2 = _run(path, "--total_steps", "4")
    assert [s for s, _, _, _ in res2.steps] == [4] and res2.statistics.step == 4
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["3", "4"]


def test_dry_run_takes_one_step_and_writes_nothing(tmp_path):
    path, cfg = _config(tmp_path)
    assert _run(path, "--dry_run") is None
    assert not os.path.exists(cfg["output_dir"])


def test_unported_paths_raise(tmp_path, monkeypatch):
    """Tensor parallelism (``tp`` over two ranks of torchrun) passes the
    mesh check that runs before any rendezvous, on a ``(1, 1, 2)`` mesh (the
    two ranks' run is ``test_torch_tensor_parallel``'s); a dir without a
    tokenizer.json raises."""
    path, cfg = _config(tmp_path)
    cfg["training"]["strategy"] = "tp"
    with open(path, "w") as f:
        json.dump(cfg, f)
    launcher = {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": "1"}
    for k, v in launcher.items():
        monkeypatch.setenv(k, v)
    assert train_main.world_size_to_come() == 2
    assert train_main.check_mesh(ExperimentConfig.from_json(path), 2) == (1, 1, 2)
    for k in launcher:
        monkeypatch.delenv(k)
    cfg["training"].pop("strategy")
    cfg["modeling"]["parameters"]["model_name"] = str(tmp_path)  # a dir, no tokenizer.json
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        _run(path)


def _hf_dir(tmp_path):
    """A tiny Llama at the fixture tokenizer's 695 ids, saved by JAX."""
    import jax
    import jax.numpy as jnp

    from tts_max_tpu.models import hf_import as jhf, llama as jllama

    jcfg = dataclasses.replace(jllama.tiny_config(vocab_size=695, max_seq_len=128),
                               dtype=jnp.float32)
    d = str(tmp_path / "llama3-tiny")
    jhf.save_model_to_hf_dir(jllama.init_params(jax.random.PRNGKey(3), jcfg), jcfg, d)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(FIXTURE, name), d)
    return d


def test_hf_dir_model_and_tokenizer_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from tts_max_tpu.core.config import ExperimentConfig as JConfig
    from tts_max_tpu.data import builder as jbuilder
    from tts_max_tpu.training import main as jmain, optim as joptim, train_step as jts

    path, cfg = _config(tmp_path)
    cfg["modeling"]["parameters"].update(model_name=_hf_dir(tmp_path), vocab_size=66304)
    with open(path, "w") as f:
        json.dump(cfg, f)
    jconfig, pconfig = JConfig.from_json(path), ExperimentConfig.from_json(path)
    jtok, jparams, jcfg = jmain.build_model_and_tokenizer(jconfig)
    ptok, pparams, pcfg = train_main.build_model_and_tokenizer(pconfig, device="cpu")
    assert len(ptok) == len(jtok) == pcfg.vocab_size == jcfg.vocab_size == 66304
    assert ptok.pad_token_id == jtok.pad_token_id == jtok.convert_tokens_to_ids("<|eot_id|>")
    assert pcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16  # compute dtype
    jflat = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                jflat[prefix + k] = np.asarray(v)

    walk(jparams)
    pflat = dict(optim.tree_items(pparams))
    assert set(pflat) == set(jflat)
    for k, v in pflat.items():  # fp32, the resized rows included
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), jflat[k]), k

    mp = pconfig.modeling.parameters
    data = cfg["train_weighted_datasets"]
    jds = jbuilder.merge_datasets(jtok, data, mp.max_seq_len, "train", False, None,
                                  jconfig.dataset)
    pds = builder.merge_datasets(ptok, data, mp.max_seq_len, "train", False, None,
                                 pconfig.dataset)
    assert len(pds) == len(jds) == 8
    items = [pds[i] for i in range(len(pds))]
    for i, item in enumerate(items):
        assert np.array_equal(item["input_ids"], jds[i]["input_ids"]), i
        assert np.array_equal(item["labels"], jds[i]["labels"]), i

    batch = collate(items[:2], pad_token_id=ptok.pad_token_id, max_seq_len=mp.max_seq_len)
    batch = {k: batch[k][None] for k in ("input_ids", "labels")}
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    pcfg32 = dataclasses.replace(pcfg, dtype=torch.float32)
    jtx, ptx = joptim.create_optimizer(1e-3), optim.create_optimizer(1e-3)
    _, _, jm = jax.jit(functools.partial(jts.train_step, cfg=jcfg32, tx=jtx))(
        jparams, jtx.init(jparams), batch)
    _, _, pm = ts.train_step(pparams, ptx.init(pparams), batch, cfg=pcfg32, tx=ptx)
    assert np.isfinite(pm.loss)
    np.testing.assert_allclose(pm.loss, float(jm.loss), rtol=1e-5)
    assert _run(path, "--dry_run") is None  # the entry point takes the dir too
