"""Training-time quality validation in the port
(``tts_max_tpu_torch/inference/quality.py`` and its wiring in
``training/main.py``) against the JAX package's ``inference/quality.py``:
the phrase grid and its sharding; ``RandomPhrasesSynthesizer`` and
``PromptContinuationValidator`` with greedy settings on a tiny Llama and a
tiny Vocos (the same converted weights and prompt codes in both packages)
write wavs within 1e-4 of JAX's validators'; a failing combo is logged, not
raised; the seeded codec checkpoints ``chip_smoke.py`` writes load back
bitwise; and ``python -m tts_max_tpu_torch.training.main`` with
``validation_type random_phrases`` and tiny codec checkpoints writes
``generations/<step>/rank0_*.wav`` at each checkpoint and trains on after
it."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu.inference import quality as jquality
from tts_max_tpu.inference import synthesize as jsyn
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models.codec import api as japi
from tts_max_tpu.models.codec import vocos as jv
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core import tokenization as ttok
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.audio_io import save_wav
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.inference import quality
from tts_max_tpu_torch.inference import synthesize as tsyn
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models.codec import api as tapi
from tts_max_tpu_torch.models.codec import encoder as tenc
from tts_max_tpu_torch.models.codec import torch_import
from tts_max_tpu_torch.models.codec import vocos as tv
from tts_max_tpu_torch.models.codec import w2vbert as tw
from tts_max_tpu_torch.training import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHRASES = ["Hello there, 42 friends!", "A second phrase."]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phrases_combinations_and_sharding_match_jax():
    assert quality.DEFAULT_PHRASES == jquality.DEFAULT_PHRASES
    wavs = {"b.wav": "two", "a.wav": "one", "c.wav": "three"}
    combos = quality.all_test_combinations(wavs, quality.DEFAULT_PHRASES)
    assert combos == [tuple(c) for c in jquality.all_test_combinations(
        wavs, jquality.DEFAULT_PHRASES)]
    assert len(combos) == 63 and combos[0][0] == "a.wav"
    for world in (1, 2, 4, 5):
        shards = [quality.shard_combinations(combos, r, world) for r in range(world)]
        assert shards == [jquality.shard_combinations(combos, r, world)
                          for r in range(world)]
        assert sum(shards, []) == combos


class StubEncoder:
    """The same seeded prompt codes for both packages."""

    def encode(self, prompt_id, wav):
        return np.random.default_rng(len(prompt_id)).integers(0, 65536, 20)


@pytest.fixture(scope="module")
def models():
    tok, ttk = jtok.build_byte_tokenizer(), ttok.build_byte_tokenizer()
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=len(tok), max_seq_len=512),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=len(ttk), max_seq_len=512),
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jvc, tvc = jv.tiny_vocos_config(), tv.tiny_vocos_config()
    jd = jv.init_decoder(jax.random.PRNGKey(1), jvc)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jmodel = jsyn.LocalTtsModel(jp, jcfg, tok, jtok.speech_vocab(tok), StubEncoder(),
                                japi.AudioDecoder(jd, jvc, japi.DecoderConfig()))
    tparams = convert.llama_from_numpy(to_np(jp), tcfg, device="cpu")
    tmodel = tsyn.LocalTtsModel(
        tparams, tcfg, ttk, ttok.speech_vocab(ttk), StubEncoder(),
        tapi.AudioDecoder(convert.vocos_from_numpy(to_np(jd), tvc, device="cpu"), tvc,
                          tapi.DecoderConfig(), device="cpu"),
        device="cpu")
    return jmodel, jp, tmodel, tparams


def _read(path):
    sr, data = wavfile.read(path)
    assert sr == 16000 and data.dtype == np.int16 and len(data) > 0
    return data.astype(np.float32) / 32767.0


def test_validators_write_the_jax_validators_wavs(models, tmp_path):
    """Greedy, 12 tokens: two prompt wavs x two phrases sharded over two
    processes (rank 1's half) and the continuation of both wavs; every wav
    file within 1e-4 of JAX's."""
    jmodel, jparams, tmodel, tparams = models
    wavs = {}
    for i in range(2):
        wavs[str(tmp_path / f"prompt{i}.wav")] = f"prompt number {i}"
        save_wav(str(tmp_path / f"prompt{i}.wav"),
                 np.random.default_rng(i).standard_normal(8000).astype(np.float32) * 0.1,
                 16000)
    js = jsyn.InferenceSettings(temperature=0.0, max_tokens=12, min_tokens=4)
    ts = tsyn.InferenceSettings(temperature=0.0, max_tokens=12, min_tokens=4)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jquality.RandomPhrasesSynthesizer(jmodel, jdir, 1, 2, wavs, PHRASES, js).validate(
        jparams, 3)
    quality.RandomPhrasesSynthesizer(tmodel, tdir, 1, 2, wavs, PHRASES, ts).validate(
        tparams, 3)
    jquality.PromptContinuationValidator(jmodel, jdir, sorted(wavs), 0, js).validate(
        jparams, 3)
    quality.PromptContinuationValidator(tmodel, tdir, sorted(wavs), 0, ts).validate(
        tparams, 3)
    files = [f"generations/3/rank1_{i}.wav" for i in range(2)] + [
        f"continuations/3/continuation_{i}.wav" for i in range(2)]
    assert sorted(os.listdir(os.path.join(tdir, "generations", "3"))) == sorted(
        os.path.basename(f) for f in files[:2])
    for f in files:
        ours, ref = _read(os.path.join(tdir, f)), _read(os.path.join(jdir, f))
        assert ours.shape == ref.shape, f
        np.testing.assert_allclose(ours, ref, atol=1e-4, err_msg=f)
    assert tmodel._params is tparams


def test_failed_combo_is_logged_not_raised(models, tmp_path):
    _, _, tmodel, tparams = models
    settings = tsyn.InferenceSettings(temperature=0.0, max_tokens=4, min_tokens=1)
    v = quality.RandomPhrasesSynthesizer(tmodel, str(tmp_path), prompt_wavs={
        str(tmp_path / "missing.wav"): "gone"}, phrases=PHRASES, settings=settings)
    v.validate(tparams, 1)  # logs both failures
    assert os.listdir(tmp_path / "generations" / "1") == []
    quality.PromptContinuationValidator(tmodel, str(tmp_path), ["x.wav"], global_rank=1,
                                        settings=settings).validate(tparams, 1)
    assert not os.path.exists(tmp_path / "continuations")
    assert isinstance(quality.create("none"), quality.NoOpQualityValidator)
    with pytest.raises(ValueError):
        quality.create("bogus")


def _tiny_codec_configs():
    wcfg = tw.W2VBertConfig(**{**tw.tiny_w2vbert_config().__dict__, "feature_dim": 160})
    ecfg = tenc.EncoderConfig(**{**tenc.tiny_encoder_config().__dict__,
                                 "semantic_input_dim": wcfg.hidden_size})
    return tv.tiny_vocos_config(), ecfg, wcfg


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _write_tiny_codec(directory):
    vcfg, ecfg, wcfg = _tiny_codec_configs()
    dec = tv.init_decoder(vcfg, seed=1, device="cpu")
    enc = tenc.init_encoder(ecfg, seed=2, device="cpu")
    w2v = tw.init_params(wcfg, seed=3, device="cpu")
    paths = _chip_smoke().write_codec_checkpoints(directory, dec, enc, w2v)
    return paths, (dec, enc, w2v), (vcfg, ecfg, wcfg)


def test_seeded_codec_checkpoints_load_back_bitwise(tmp_path):
    (dec_path, enc_path), (dec, enc, w2v), (vcfg, ecfg, wcfg) = _write_tiny_codec(
        str(tmp_path))
    sd = torch_import.load_torch_checkpoint(dec_path)
    got = torch_import.import_decoder(sd, vcfg, device="cpu")
    assert dict(_leaves(got)).keys() >= dict(_leaves(dec)).keys()
    sd = torch_import.load_torch_checkpoint(enc_path)
    got_enc = torch_import.import_encoder(sd, ecfg, device="cpu")
    got_w2v = convert.w2vbert_from_numpy(
        tw.import_hf_state_dict(torch.load(enc_path, weights_only=False), wcfg), wcfg,
        device="cpu")
    for want, have in ((dec, got), (enc, got_enc), (w2v, got_w2v)):
        have = dict(_leaves(have))
        for k, t in _leaves(want):
            assert torch.equal(have[k], t), k


def _train_config(tmp_path):
    data = str(tmp_path / "tiny")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        lens = rng.integers(20, 40, n)
        codes = rng.integers(0, 65536, int(lens.sum())).astype(np.int32)
        index = np.concatenate([[0], np.cumsum(lens)[:-1]])
        samples = [Sample.from_json({"id": f"{split}{i}", "wav_path": f"{split}{i}.wav",
                                     "transcript": f"hello number {i}", "language": "en",
                                     "duration": 0.6, "sample_rate": 16000}, "tiny")
                   for i in range(n)]
        codes_io.write_shard(data, split, codes, index, samples)
    cfg = {"training": {"batch_size": 2, "logging_steps": 1, "eval_steps": 10, "seed": 1,
                        "precision": "fp32", "loss_chunk_size": 16},
           "modeling": {"parameters": {"model_name": "from-scratch",
                                       "architecture": "llama-tiny", "max_seq_len": 128}},
           "checkpointing": {"save_steps": 1, "keep_only_last_n_checkpoints": 1,
                             "validation_type": "random_phrases"},
           "train_weighted_datasets": {data: 1.0}, "val_weighted_datasets": {data: 1.0},
           "output_dir": str(tmp_path / "out")}
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


def test_train_main_runs_random_phrases_validation(tmp_path, monkeypatch):
    """Two steps with a checkpoint and a validation after each: two phrases
    on one prompt wav (48 tokens each) through the tiny codec, read from
    checkpoints at the published layouts; step 2 trains after step 1's
    validation."""
    (dec_path, enc_path), _, (vcfg, ecfg, wcfg) = _write_tiny_codec(str(tmp_path / "codec"))
    # the codec factories build the published widths: point them at the tiny ones
    monkeypatch.setattr(tapi.DecoderConfig, "vocos_config", lambda self: vcfg)
    monkeypatch.setattr(tenc, "EncoderConfig", lambda: ecfg)
    monkeypatch.setattr(tw, "W2VBertConfig", lambda: wcfg)
    monkeypatch.setattr(quality, "DEFAULT_PHRASES", PHRASES)
    monkeypatch.setattr(quality, "InferenceSettings",
                        lambda max_tokens: tsyn.InferenceSettings(max_tokens=48))
    prompt = str(tmp_path / "prompt.wav")
    save_wav(prompt, np.random.default_rng(0).standard_normal(16000).astype(np.float32) * 0.1,
             16000)
    path, cfg = _train_config(tmp_path)
    res = train_main.main(["--config_path", path, "--device", "cpu", "--total_steps", "2",
                           "--codec_decoder_checkpoint", dec_path,
                           "--codec_encoder_checkpoint", enc_path,
                           "--validation_prompt_wavs", f"{prompt}:a short prompt"])
    assert [s for s, _, _, _ in res.steps] == [1, 2]
    assert all(np.isfinite(m.loss) for _, m, _, _ in res.steps)
    for step in (1, 2):
        out = os.path.join(cfg["output_dir"], "generations", str(step))
        assert sorted(os.listdir(out)) == ["rank0_0.wav", "rank0_1.wav"]
        for name in os.listdir(out):
            assert np.isfinite(_read(os.path.join(out, name))).all()
