"""The port's RLHF entry point, ``python -m
tts_max_tpu_torch.training.rlhf.main``, on the CPU: ``llama-tiny`` over the
byte tokenizer, a dataset written with the port's ``codes_io`` whose
samples' wavs exist, and every reward backed by a tiny model written to
disk the way real checkpoints come (a Whisper HF dir with the fixture
Whisper-shaped tokenizer, DNSMOS ONNX graphs from the port's writer, a
WavLM HF dir and a UniSpeech-named ECAPA checkpoint with
``feature_weight``), found through the environment variables. Two GRPO
steps write finite metrics, a checkpoint and the first reward's wavs, and
every completion is transcribed, scored and embedded by its backend; a
step through the serving engine (``--rollout_via_engine``) runs with the
default rewards; ``--sampler_devices 1`` in one process raises JAX's
``ValueError`` (no rank is left to train); an HF dir as
``--model_dir`` (a tiny Llama beside the Llama-3-style fixture tokenizer)
trains fp32 weights (JAX's import) under the config's bf16 compute, with
remat, its tokenizer extended to the model's ids, with rollouts through
``generate`` and through the engine."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.audio_io import save_wav
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.models import wavlm, whisper
from tts_max_tpu_torch.training import optim
from tts_max_tpu_torch.training.rlhf import asr, ecapa
from tts_max_tpu_torch.training.rlhf import main as rlhf_main
from tts_max_tpu_torch.utils import onnx_lite as ox

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHISPER_TOKENIZER = os.path.join(ROOT, "tests", "fixtures", "whisper_style_tokenizer")


def _dataset(path, wav_dir):
    rng = np.random.default_rng(0)
    n = 4
    lens = rng.integers(10, 20, n)
    codes = rng.integers(0, 65536, int(lens.sum())).astype(np.int32)
    index = np.concatenate([[0], np.cumsum(lens)[:-1]])
    samples = []
    for i in range(n):
        wav = os.path.join(wav_dir, f"s{i}.wav")
        save_wav(wav, (np.sin(np.arange(8000) / (5.0 + i)) * 0.2).astype(np.float32), 16000)
        samples.append(Sample.from_json({"id": f"s{i}", "wav_path": wav,
                                         "transcript": f"hello number {i}", "language": "en",
                                         "duration": 0.5, "sample_rate": 16000}, "tiny"))
    codes_io.write_shard(path, "train", codes, index, samples)


def _write_backends(d):
    """Tiny reward models on disk: (whisper dir, dnsmos dir, wavlm dir,
    ecapa checkpoint)."""
    tok = asr.WhisperTokenizer(WHISPER_TOKENIZER)
    wcfg = whisper.WhisperConfig(
        n_mels=16, vocab_size=len(tok), d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, ffn_dim=64, max_source_positions=24, max_target_positions=224,
        decoder_start_token_id=tok.convert_tokens_to_ids("<|startoftranscript|>"),
        eos_token_id=tok.convert_tokens_to_ids("<|endoftext|>"))
    wdir = os.path.join(d, "whisper")
    whisper.save_hf_dir(whisper.init_params(wcfg, seed=1, device="cpu"), wcfg, wdir)
    for name in os.listdir(WHISPER_TOKENIZER):
        shutil.copy(os.path.join(WHISPER_TOKENIZER, name), wdir)

    ddir = os.path.join(d, "dnsmos")
    os.makedirs(ddir)
    w = np.asarray([[0.1, 0.2, 0.3]], np.float32)
    with open(os.path.join(ddir, "sig_bak_ovr.onnx"), "wb") as f:
        f.write(ox.build_model_bytes([
            ox.encode_node("ReduceMean", ["input_1"], ["m"], axes=[1], keepdims=1),
            ox.encode_node("Abs", ["m"], ["a"]),
            ox.encode_node("Gemm", ["a", "w", "b"], ["out"])],
            ["input_1"], ["out"], {"w": w, "b": np.asarray([3.0, 3.1, 3.2], np.float32)}))
    with open(os.path.join(ddir, "model_v8.onnx"), "wb") as f:
        f.write(ox.build_model_bytes([
            ox.encode_node("ReduceMean", ["input_1"], ["m"], axes=[1, 2], keepdims=0),
            ox.encode_node("Add", ["m", "c"], ["out"])],
            ["input_1"], ["out"], {"c": np.asarray([3.0], np.float32)}))

    vcfg = wavlm.tiny_wavlm_config()
    vdir = os.path.join(d, "wavlm")
    wavlm.save_hf_dir(wavlm.init_params(vcfg, seed=2, device="cpu"), vcfg, vdir)
    ecfg = ecapa.ECAPAConfig(feat_dim=vcfg.hidden_size)
    sd = ecapa.export_torch_state_dict(ecapa.init_params(ecfg, seed=3, device="cpu"), ecfg)
    sd["feature_weight"] = torch.linspace(-1, 1, vcfg.num_layers + 1)
    ckpt = os.path.join(d, "ecapa.pt")
    torch.save({"model": sd}, ckpt)
    return wdir, ddir, vdir, ckpt


def _config(tmp_path, **rlhf):
    with open(os.path.join(ROOT, "example", "configs", "rlhf.json")) as f:
        cfg = json.load(f)
    cfg["training"].update(batch_size=1, logging_steps=1)
    cfg["checkpointing"] = {"save_steps": 2, "keep_only_last_n_checkpoints": 1}
    cfg["rlhf"].update(num_generations=2, max_prompt_length=128, max_completion_length=8,
                       save_completions_every_n_steps=1, **rlhf)
    cfg["output_dir"] = str(tmp_path / "out")
    path = str(tmp_path / "rlhf.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


@pytest.fixture
def data(tmp_path):
    ds = str(tmp_path / "ds")
    os.makedirs(tmp_path / "wavs")
    _dataset(ds, str(tmp_path / "wavs"))
    return ds


def _run(path, ds, *extra):
    return rlhf_main.main(["--config_path", path, "--dataset_dir", ds, "--architecture",
                           "llama-tiny", "--device", "cpu", *extra])


def test_two_steps_with_every_backend(tmp_path, data, monkeypatch):
    wdir, ddir, vdir, ckpt = _write_backends(str(tmp_path))
    for var, value in (("WHISPER_CHECKPOINT", wdir), ("DNSMOS_ONNX_DIR", ddir),
                       ("WAVLM_CHECKPOINT", vdir), ("ECAPA_CHECKPOINT", ckpt)):
        monkeypatch.setenv(var, value)
    path, cfg = _config(tmp_path)
    res = _run(path, data, "--total_steps", "2")
    out = cfg["output_dir"]
    assert [s["step"] for s in res.steps] == [1, 2]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2
    for r in records:
        for k in ("loss", "grad_norm", "mean_logp", "reward_mean", "WERRewardFunc",
                  "DNSMOSRewardFunc", "SimilarityRewardFunc"):
            assert np.isfinite(r[k]), k
    assert os.listdir(os.path.join(out, "checkpoints")) == ["2"]
    assert os.path.isfile(os.path.join(out, "training_config.json"))
    assert len(os.listdir(os.path.join(out, "completion_samples"))) > 0
    assert res.checkpoint_seconds and len(res.checkpoint_seconds) == 1
    b = res.backends
    assert set(b) == {"transcribe_fn", "dnsmos_fn", "embed_fn"}
    n = 2 * 2  # steps x completions a step
    assert (b["transcribe_fn"].calls, b["transcribe_fn"].completed) == (n, n)
    assert (b["dnsmos_fn"].calls, b["dnsmos_fn"].completed) == (n, n)
    assert (b["embed_fn"].calls, b["embed_fn"].completed) == (2 * n, 2 * n)
    assert res.trainer.rollout_params is not res.trainer.params


def test_engine_rollouts_and_refusals(tmp_path, data):
    path, cfg = _config(tmp_path)
    res = _run(path, data, "--total_steps", "1", "--rollout_via_engine")
    eng = res.trainer._engine
    assert eng is not None and res.steps[0]["decode_steps"] > 0
    assert np.isfinite(res.steps[0]["loss"]) and not res.backends
    with pytest.raises(ValueError, match="n_sampler=1 must leave >=1 trainer device of 1"):
        _run(path, data, "--sampler_devices", "1")  # JAX's error: one process, no trainer


def test_hf_dir_policy(tmp_path, data):
    from tts_max_tpu_torch.core.tokenization import build_tokenizer
    from tts_max_tpu_torch.models import hf_import, llama

    fixture = os.path.join(ROOT, "tests", "fixtures", "llama3_style_tokenizer")
    hf = str(tmp_path / "hf")
    os.makedirs(hf)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(fixture, name), hf)
    n = len(build_tokenizer(hf, expected_vocab_size=None))
    cfg = llama.tiny_config(vocab_size=n)
    hf_import.save_model_to_hf_dir(llama.init_params(cfg, seed=4, device="cpu"), cfg, hf)
    path, _ = _config(tmp_path)
    res = rlhf_main.main(["--config_path", path, "--dataset_dir", data, "--model_dir", hf,
                          "--total_steps", "1", "--device", "cpu"])
    trainer = res.trainer
    # fp32 weights as JAX's import gives them, the config's bf16 compute, remat
    assert trainer.cfg.vocab_size == len(trainer.tokenizer) == n and trainer.cfg.remat
    assert trainer.cfg.dtype == torch.bfloat16
    assert {t.dtype for t in optim.tree_leaves(trainer.params)} == {torch.float32}
    assert np.isfinite(res.steps[0]["loss"]) and res.steps[0]["grad_norm"] > 0
    # the engine serves the fp32 weights under the bf16 compute dtype too
    path, _ = _config(tmp_path, constrain_to_speech=True)
    res = rlhf_main.main(["--config_path", path, "--dataset_dir", data, "--model_dir", hf,
                          "--total_steps", "1", "--rollout_via_engine", "--device", "cpu"])
    eng = res.trainer._engine
    assert eng.params is res.trainer.params and res.steps[0]["decode_steps"] > 0
    assert np.isfinite(res.steps[0]["loss"]) and res.steps[0]["grad_norm"] > 0
