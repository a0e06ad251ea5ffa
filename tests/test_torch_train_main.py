"""The port's SFT entry point, ``python -m tts_max_tpu_torch.training.main``,
on the CPU: a tiny from-scratch config (the byte tokenizer, ``llama-tiny``)
over a dataset written with the port's ``codes_io.write_shard``. Three steps
write finite losses to the metrics log, the config, a checkpoint and the
final model; ``--dry_run`` takes one step and writes nothing; a rerun with a
higher ``--total_steps`` resumes from the checkpoint and continues the step
count; what is not ported yet raises."""

import json
import os

import numpy as np
import pytest
import torch

from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.training import main as train_main


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


def test_unported_paths_raise(tmp_path):
    path, cfg = _config(tmp_path)
    cfg["training"]["mesh"] = {"data": 2, "fsdp": 1, "tensor": 1}
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        _run(path)
    cfg["training"].pop("mesh")
    cfg["modeling"]["parameters"]["model_name"] = str(tmp_path)  # an HF dir
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="item 1b"):
        _run(path)
