"""Draft distillation in the port (``tts_max_tpu_torch/training/distill.py``,
``tools/distill_draft.py``) against the JAX package's
``training/distill.py`` on the same tiny 4-layer Llama in fp32: the draft's
shapes and copied leaves; ``distill_loss`` within 1e-5 relative of JAX's on
ragged masks, with a chunk that divides S - 1 and one that does not; one
``make_distill_step`` against JAX's jitted step under ``optax.adamw`` (loss,
grad norm and the updated draft); a short distillation that lowers the KL;
and ``python -m tts_max_tpu_torch.tools.distill_draft`` on the CPU, whose
draft dir loads through ``hf_import``; with ``--model_dir`` the tool reads
the dir's ``tokenizer.json`` (JAX's ``build_tokenizer`` with no padding
ids), falls back to the byte tokenizer only when the dir has none, and
raises on a malformed one."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.training import distill as jdistill
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.models import hf_import, llama
from tts_max_tpu_torch.tools import distill_draft
from tts_max_tpu_torch.training import distill
from tts_max_tpu_torch.training.optim import AdamW, tree_items

VOCAB = 128


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jllama.tiny_config(vocab_size=VOCAB, max_seq_len=64),
                               n_layers=4, dtype=jnp.float32)
    pcfg = dataclasses.replace(llama.tiny_config(vocab_size=VOCAB, max_seq_len=64),
                               n_layers=4, dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                       device="cpu")
    return jcfg, pcfg, jparams, pparams


def _flat(tree):
    return {k: v.detach().numpy() for k, v in tree_items(tree)}


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_truncated_draft_shapes_and_copies(setup):
    _, pcfg, _, pparams = setup
    draft, dcfg = distill.truncated_draft(pparams, pcfg, 2)
    assert dcfg.n_layers == 2 and dcfg.dim == pcfg.dim
    for k, t in tree_items(draft):
        src = dict(tree_items(pparams))[k]
        want = src[:2] if k.startswith("layers/") else src
        assert torch.equal(t, want), k
        assert t.data_ptr() != src.data_ptr() and t.is_contiguous(), k
    draft["embed"]["embedding"].add_(1.0)
    assert not torch.equal(draft["embed"]["embedding"], pparams["embed"]["embedding"])
    with pytest.raises(ValueError):
        distill.truncated_draft(pparams, pcfg, 5)


@pytest.mark.parametrize("chunk", [8, 7])
def test_distill_loss_matches_jax(setup, chunk):
    """S = 33: 32 next-token positions, cut in chunks of 8 (dividing) or 7
    (not dividing); rows ragged at 20, 33 and 9 real positions."""
    jcfg, pcfg, jparams, pparams = setup
    jdraft, jdcfg = jdistill.truncated_draft(jparams, jcfg, 2)
    pdraft, pdcfg = distill.truncated_draft(pparams, pcfg, 2)
    # a draft that differs from the target's truncation, so the KL is not tiny
    rng = np.random.default_rng(1)
    noise = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.05
             for k, v in _jflat(jdraft).items()}
    jdraft = jax.tree_util.tree_map_with_path(
        lambda p, x: x + noise["/".join(str(q.key) for q in p)], jdraft)
    pdraft = {**pdraft}
    for k, t in tree_items(pdraft):
        t.add_(torch.from_numpy(noise[k]))
    toks = rng.integers(0, VOCAB, (3, 33)).astype(np.int32)
    mask = np.arange(33)[None, :] < np.asarray([[20], [33], [9]])
    ref = jdistill.distill_loss(jdraft, jparams, jnp.asarray(toks), jnp.asarray(mask),
                                draft_cfg=jdcfg, target_cfg=jcfg, chunk_size=chunk)
    ours = distill.distill_loss(pdraft, pparams, torch.from_numpy(toks).long(),
                                torch.from_numpy(mask), draft_cfg=pdcfg, target_cfg=pcfg,
                                chunk_size=chunk)
    assert float(ref) > 1e-3
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    # and the dense computation, as JAX's own test holds it
    tl = torch.log_softmax(llama.forward(pparams, pcfg, torch.from_numpy(toks))[:, :-1], -1)
    dl = torch.log_softmax(llama.forward(pdraft, pdcfg, torch.from_numpy(toks))[:, :-1], -1)
    kl = (tl.exp() * (tl - dl)).sum(-1)
    m = torch.from_numpy(mask[:, 1:])
    np.testing.assert_allclose(float(ours), float((kl * m).sum() / m.sum()), rtol=1e-5)


def test_distill_step_matches_jax(setup):
    """One step at ``optax.adamw(3e-3, eps=1e-3)`` (b2 0.999, weight decay
    1e-4) and a clip of 0.05, below the grad norm: the loss, the norm and
    every updated leaf of the draft. The larger eps, on both sides, keeps the
    first update smooth in the grads: at optax's 1e-8 Adam's first update is
    about lr * sign(g), so a grad near zero whose fp32 sum differs in sign
    between the packages moves its weight by up to 2 lr."""
    jcfg, pcfg, jparams, pparams = setup
    jdraft, jdcfg = jdistill.truncated_draft(jparams, jcfg, 1)
    pdraft, pdcfg = distill.truncated_draft(pparams, pcfg, 1)
    tx = optax.adamw(3e-3, eps=1e-3)
    jstep = jdistill.make_distill_step(jdcfg, jcfg, tx, chunk_size=16, grad_clip=0.05)
    ptx = AdamW(3e-3, betas=(0.9, 0.999), weight_decay=1e-4)
    ptx.eps = 1e-3
    pstep = distill.make_distill_step(pdcfg, pcfg, ptx, chunk_size=16, grad_clip=0.05)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, VOCAB, (4, 24)).astype(np.int32)
    mask = np.arange(24)[None, :] < np.asarray([[24], [17], [24], [5]])
    jstate = tx.init(jdraft)
    jnew, _, jloss, jnorm = jstep(jdraft, jparams, jstate, jnp.asarray(toks),
                                  jnp.asarray(mask))
    pnew, _, ploss, pnorm = pstep(pdraft, pparams, ptx.init(pdraft), toks, mask)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=1e-4)
    assert float(jnorm) > 0.05  # the clip scaled the grads
    ref = _jflat(jax.tree_util.tree_map(np.asarray, jnew))
    for k, v in _flat(pnew).items():
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-5 * max(np.abs(ref[k]).max(), 1),
                                   err_msg=k)
    assert not np.array_equal(_flat(pnew)["embed/embedding"],
                              _flat(pdraft)["embed/embedding"])


def test_short_distillation_lowers_kl(setup):
    """20 steps of a 1-layer draft under the 4-layer target at AdamW 3e-3,
    as JAX's test trains it, over two fixed batches (JAX's test takes 300
    steps over fresh ones): the last KL under 0.75 of the first, JAX's bar."""
    _, pcfg, _, pparams = setup
    draft, dcfg = distill.truncated_draft(pparams, pcfg, 1)
    tx = AdamW(3e-3, betas=(0.9, 0.999), weight_decay=1e-4)
    state = tx.init(draft)
    step = distill.make_distill_step(dcfg, pcfg, tx, chunk_size=32)
    batches = [np.random.default_rng(s).integers(0, VOCAB, (4, 48)).astype(np.int32)
               for s in (0, 1)]
    losses = []
    for i in range(20):
        draft, state, loss, _ = step(draft, pparams, state, batches[i % 2],
                                     np.ones((4, 48), bool))
        losses.append(float(loss))
    assert losses[-1] < 0.75 * losses[0], losses


def _dataset(path):
    rng = np.random.default_rng(0)
    lens = rng.integers(20, 60, 6)
    codes = rng.integers(0, 65536, int(lens.sum())).astype(np.int32)
    index = np.concatenate([[0], np.cumsum(lens)[:-1]])
    samples = [Sample.from_json({"id": f"s{i}", "wav_path": f"s{i}.wav",
                                 "transcript": f"hello number {i}", "language": "en",
                                 "duration": 1.0, "sample_rate": 16000}, "tiny")
               for i in range(6)]
    codes_io.write_shard(path, "train", codes, index, samples)


def test_distill_draft_end_to_end(tmp_path):
    data, out = str(tmp_path / "ds"), str(tmp_path / "draft")
    _dataset(data)
    res = distill_draft.main(["--dataset_dir", data, "--output_dir", out,
                              "--architecture", "llama-tiny", "--draft_layers", "1",
                              "--steps", "3", "--batch", "2", "--seq", "96", "--chunk", "32",
                              "--log_steps", "1", "--device", "cpu"])
    assert len(res.kl) == 3 and np.isfinite(res.kl).all() and np.isfinite(res.grad_norm).all()
    assert res.tokens_per_step == 2 * 96 and res.draft_cfg.n_layers == 1
    assert len(res.real_tokens) == 3 and all(0 < n <= 2 * 96 for n in res.real_tokens)
    assert res.first_seconds > 0 and res.rest_seconds > 0
    params, cfg = hf_import.load_model_from_hf_dir(out, device="cpu", dtype=torch.float32)
    assert cfg.n_layers == 1 and cfg.vocab_size == res.draft_cfg.vocab_size
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["num_hidden_layers"] == 1
    assert params["layers"]["attn"]["wq"]["kernel"].shape[0] == 1


def test_distill_draft_reads_the_model_dirs_tokenizer(tmp_path, setup, monkeypatch):
    from tts_max_tpu.core.tokenization import build_tokenizer as jbuild

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "llama3_style_tokenizer")
    data = str(tmp_path / "ds")
    _dataset(data)
    vocab = 695 + 65544  # the fixture's ids and the speech vocabulary, no padding ids
    _, pcfg, _, _ = setup
    cfg = dataclasses.replace(pcfg, vocab_size=vocab, n_layers=2)
    model_dir = str(tmp_path / "target")
    hf_import.save_model_to_hf_dir(llama.init_params(cfg, seed=0, device="cpu"), cfg,
                                   model_dir)
    seen = []
    dataset = distill_draft.TtsFineTuningDataset

    def record(name, samples, codes, spans, tokenizer, **kw):
        seen.append(tokenizer)
        return dataset(name, samples, codes, spans, tokenizer, **kw)

    monkeypatch.setattr(distill_draft, "TtsFineTuningDataset", record)
    argv = ["--dataset_dir", data, "--model_dir", model_dir, "--draft_layers", "1",
            "--steps", "1", "--batch", "2", "--seq", "64", "--chunk", "32", "--device", "cpu"]
    # no tokenizer.json: the byte tokenizer, as serving dirs carry none
    distill_draft.main(argv + ["--output_dir", str(tmp_path / "d0")])
    assert len(seen[-1]) == 65806 and seen[-1].pad_token_id == 0
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(fixture, name), model_dir)
    res = distill_draft.main(argv + ["--output_dir", str(tmp_path / "d1")])
    ref, tok = jbuild(model_dir, expected_vocab_size=None), seen[-1]
    assert len(tok) == len(ref) == vocab and tok.pad_token_id == ref.pad_token_id == 692
    prompt = "<|text_prompt_start|>hello number 3<|text_prompt_end|><|s_5|><|s_65535|>"
    assert tok.encode(prompt) == ref.encode(prompt)
    assert np.isfinite(res.kl).all() and res.draft_cfg.vocab_size == vocab
    with open(os.path.join(model_dir, "tokenizer.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(json.JSONDecodeError):
        distill_draft.main(argv + ["--output_dir", str(tmp_path / "d2")])
