"""``correct`` comes out false when the timed path is broken: a whole run of
each loop at a tiny size on the CPU (the card check skipped), once sound,
once with each fault its cell can have planted underneath (a token altered
where it is produced, a step that returns its state unchanged, half of the
batch left out), and once read by the control, the reference in float8.
The limits are the cells' own, from their workload files."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.loops import serve, train  # noqa: E402
from benchmark.run import Cell, drive, verdict  # noqa: E402

SEED = 2 ** 31 + 4242


def tiny_conf(dtype):
    # the TTS vocabulary's speech window ends at id 65804
    return {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 1024,
            "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "rope_scaling": None,
            "tie_word_embeddings": True, "torch_dtype": dtype, "vocab_size": 65856}


def serve_cell(device="cpu", seconds=3.0):
    mix = harness.load_json("traffic", "clone64")
    mix.update(clients=4, block=8, greedy_every=2)
    mix["prompt"] = dict(mix["prompt"], voices=2, voice_codes=[20, 60])
    mix["output"] = dict(mix["output"], median_tokens=24, min_tokens=16, max_tokens=40)
    wl = harness.load_json("workloads", "smollm2-1.7b.clone64")
    wl["engine"] = dict(wl["engine"], max_batch=4, max_len=256)
    wl["correct"] = dict(wl["correct"], compared_tokens=48, sample_requests=4)
    return Cell("tiny.clone", wl, tiny_conf("bfloat16"), mix, SEED, seconds, False,
                torch.device(device))


def train_cell():
    mix = harness.load_json("traffic", "sft")
    mix.update(buckets=[64, 128, 256], duration_s={"median": 1.0, "sigma": 0.5, "min": 0.5, "max": 3.0})
    wl = harness.load_json("workloads", "smollm2-1.7b.sft")
    return Cell("tiny.sft", wl, tiny_conf("float32"), mix, SEED, 1.0, False, torch.device("cpu"))


@pytest.fixture(scope="module")
def sound_serve():
    cell = serve_cell()
    return cell, drive(cell)


@pytest.fixture(scope="module")
def sound_train():
    cell = train_cell()
    return cell, drive(cell)


def test_serve_sound_run_is_correct(sound_serve):
    _, out = sound_serve
    assert verdict(out["checks"]), out["checks"]


@pytest.mark.parametrize("fault", sorted(serve.FAULTS))
def test_serve_fault_is_not_correct(fault):
    cell = serve_cell()
    cell.patches.append(serve.FAULTS[fault])
    assert not verdict(drive(cell)["checks"])


def test_serve_control_is_not_correct(sound_serve):
    cell, out = sound_serve
    reading = serve.control_reading(cell, out["compared"])
    assert reading["served_token_gap"] > cell.workload["correct"]["served_token_gap"]


def test_train_sound_run_is_correct(sound_train):
    _, out = sound_train
    assert verdict(out["checks"]), out["checks"]


@pytest.mark.parametrize("fault", sorted(train.FAULTS))
def test_train_fault_is_not_correct(fault):
    cell = train_cell()
    cell.patches.append(train.FAULTS[fault])
    assert not verdict(drive(cell)["checks"])


def test_train_control_is_not_correct(sound_train):
    cell, out = sound_train
    reading = train.control_reading(cell, out["compared"])
    limits = cell.workload["correct"]
    assert any(v > limits[k] for k, v in reading.items()), reading


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_serve_on_the_card_is_correct(card):
    """The tiny cell through the port's kernels (A, C) on the card."""
    harness.set_cache_dirs()
    cell = serve_cell("cuda", seconds=2.0)
    cell.conf = dict(cell.conf, hidden_size=256, intermediate_size=512)  # head_dim 64
    out = drive(cell)
    assert verdict(out["checks"]), out["checks"]
