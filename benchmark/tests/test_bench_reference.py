"""The plain reference against the port at a tiny size on the CPU, in
float32: the next-token logits of a sequence (tied and untied heads, GQA
and multi-head), and three optimizer steps of SFT (losses, the clipped
first gradient, the change of every leaf)."""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.loops import train as train_loop  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference import llama as ref  # noqa: E402


def tiny(tied=True, kv_heads=2, vocab=96):
    return {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": kv_heads,
            "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "rope_scaling": None, "tie_word_embeddings": tied, "torch_dtype": "float32",
            "vocab_size": vocab}


@pytest.mark.parametrize("tied, kv_heads", [(True, 2), (False, 4)])
def test_next_token_logits_match_the_port(tied, kv_heads):
    from tts_max_tpu_torch.models import llama

    conf = tiny(tied, kv_heads)
    cfg = harness.model_config(conf)
    weights = harness.make_weights(cfg, 5, torch.device("cpu"))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 96, 40))
    want = llama.forward(weights, cfg, tokens[None])[0]
    got = ref.next_token_logits(weights, conf, tokens, np.arange(40), (0, 96))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    window = ref.next_token_logits(weights, conf, tokens, [3, 39], (10, 50))
    assert torch.allclose(window, want[[3, 39], 10:60], atol=2e-5, rtol=1e-5)
    gaps = compare.token_gaps(got, want.argmax(-1))
    assert float(gaps.max()) == 0.0


def test_training_steps_match_the_port():
    from tts_max_tpu_torch.data.collate import collate
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training import train_step as ts

    conf = tiny(tied=True, vocab=128)
    cfg = harness.model_config(conf, remat=True)
    weights = harness.make_weights(cfg, 9, torch.device("cpu"))
    start = {k: v.clone() for k, v in ref.leaves_of(weights, ref.Spec(conf)).items()}
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        feats = []
        for n in rng.integers(20, 60, size=4):
            ids = rng.integers(1, 128, size=n).astype(np.int32)
            labels = ids.copy()
            labels[: n // 3] = -100
            feats.append({"input_ids": ids, "labels": labels, "tokens_processed": n,
                          "audio_processed_sec": 0.0})
        batches.append(collate(feats, pad_token_id=0, buckets=(64,), max_seq_len=64))
    tx = optim.create_optimizer(optim.constant_schedule(1e-3), (0.9, 0.95), 0.1)
    step = functools.partial(ts.train_step, cfg=cfg, tx=tx, gradient_clip_value=0.5,
                             loss_chunk_size=16)
    params, state = weights, tx.init(weights)
    losses, grads = [], None
    spec = ref.Spec(conf)
    for i, b in enumerate(batches):
        params, state, m = step(params, state, {"input_ids": b["input_ids"][None],
                                                "labels": b["labels"][None]})
        losses.append(m.loss)
        if i == 0:
            grads = train_loop.leaf_norms(state["mu"], spec, 1 / 0.1)
    change = {k: float((v - start[k]).norm()) for k, v in ref.leaves_of(params, spec).items()}
    out = ref.train(weights, conf, [(torch.as_tensor(b["input_ids"]), torch.as_tensor(b["labels"]))
                                    for b in batches], lr=1e-3, clip=0.5)
    assert compare.loss_gap(losses, out["losses"]) < 1e-5
    assert compare.leaf_gap(grads, out["grad_norm"])[0] < 1e-4
    assert compare.leaf_gap(change, out["change_norm"])[0] < 1e-3
    assert set(compare.moved_leaves(out["grad_norm"])) == set(out["grad_norm"])
