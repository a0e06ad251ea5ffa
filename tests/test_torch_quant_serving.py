"""Weight-only quantized serving in the port against the JAX package, on the
CPU: pre-quantized serving dirs and the three serving CLIs.

A dir that the JAX package's ``save_quantized_dir`` writes loads in the port
bitwise, and the port's dir loads in JAX bitwise (int8 and int4-g128). The
CLIs (``--device cpu --dtype float32``) with ``--quantize int8``,
``--quantize int4-g128`` and on a pre-quantized dir give the greedy speech
ids of the JAX package on the same dir, quantized as the JAX CLIs quantize
(``quantize_for_serving``), and the same wavs: ``serving_inference``
against JAX's ``LocalTtsModel``, ``serve_batch`` and ``serve_http`` against
JAX's contiguous engine (``delta_kv=False``). The codec runs in smoke mode
and the JAX side gets the port's smoke codec, as in
``test_torch_serving.py``. The model is dim 128, ffn 256, so that 128-row
groups divide every contraction dim.
"""

import argparse
import dataclasses
import http.client
import json
import logging
import struct
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tts_max_tpu.core import prompting as jprompting
from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu.data import normalization as jnorm
from tts_max_tpu.inference import engine as je
from tts_max_tpu.inference import synthesize as jsyn
from tts_max_tpu.models import hf_import as jhf
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models import quantization as jq
from tts_max_tpu.models.codec import api as japi
from tts_max_tpu.models.codec import vocos as jv
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch.models import hf_import as thf
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models import quantization as tq
from tts_max_tpu_torch.tools import serve_batch, serve_http, serving_inference

CPU = ["--device", "cpu", "--dtype", "float32"]
TEXT = "Hello there, 42 friends!"
TRANSCRIPT = "reference speech"
MODES = ["int8", "int4-g128", "dir"]  # "dir": a pre-quantized int8 dir written by JAX


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_bitwise(ours, ref) -> None:
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(ours) == sorted(ref)
    for name, a in ours.items():
        b = np.asarray(ref[name])
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _cfg(vocab: int, tied: bool = True):
    return dataclasses.replace(jl.tiny_config(vocab_size=vocab, max_seq_len=512),
                               dtype=jnp.float32, dim=128, ffn_dim=256, head_dim=32,
                               tie_embeddings=tied)


# --- pre-quantized dirs -----------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", ["int8", "int4-g128"])
def test_jax_quantized_dir_loads_in_the_port_bitwise(mode, tied, tmp_path):
    cfg = _cfg(96, tied)
    bits = 8 if mode == "int8" else 4
    params = jq.quantize_llama_params(jl.init_params(jax.random.PRNGKey(6), cfg), bits=bits,
                                      group_size=None if bits == 8 else 128)
    jhf.save_quantized_dir(params, cfg, str(tmp_path), bits=bits)
    assert thf.is_quantized_dir(str(tmp_path))
    ours, tcfg = thf.load_serving_model(str(tmp_path), device="cpu", dtype=torch.float32)
    ref, rcfg = jhf.load_quantized_dir(str(tmp_path))
    _assert_bitwise(ours, ref)
    assert tcfg.dtype == torch.float32
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "norm_eps", "rope_theta", "max_seq_len", "tie_embeddings",
              "use_llama3_rope_scaling"):
        assert getattr(tcfg, f) == getattr(rcfg, f), f
    # and it serves: logits of the loaded tree equal those of the tree written
    toks = np.random.default_rng(0).integers(0, 96, (1, 9)).astype(np.int32)
    want = np.asarray(jl.forward(params, cfg, jnp.asarray(toks)))
    got = tl.forward(ours, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int4-g128"])
def test_port_quantized_dir_loads_in_jax_bitwise(mode, tmp_path):
    cfg = _cfg(96)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=96, max_seq_len=512),
                               dtype=torch.float32, dim=128, ffn_dim=256, head_dim=32)
    from tts_max_tpu_torch import convert

    fp32 = convert.llama_from_numpy(
        jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(7), cfg)), tcfg,
        device="cpu")
    ours = tq.quantize_for_serving(fp32, mode)
    thf.save_quantized_dir(ours, tcfg, str(tmp_path), bits=8 if mode == "int8" else 4)
    with open(tmp_path / "quantized_config.json") as f:
        assert json.load(f)["bits"] == (8 if mode == "int8" else 4)
    ref, rcfg = jhf.load_serving_model(str(tmp_path))
    _assert_bitwise(ours, ref)
    assert (rcfg.dim, rcfg.ffn_dim, rcfg.vocab_size) == (128, 256, 96)
    again, _ = thf.load_quantized_dir(str(tmp_path), device="cpu")
    _assert_bitwise(again, ref)


def test_cli_ignores_quantize_on_a_pre_quantized_dir(served, caplog):
    """``--quantize`` on a pre-quantized dir: the same warning as the JAX
    CLIs, and the dir's own levels are served."""
    args = argparse.Namespace(
        model_dir=served["dirs"]["dir"], quantize="int4", dtype="float32", device="cpu")
    with caplog.at_level(logging.WARNING):
        params, cfg, _ = serving_inference.load_model(args)
    assert "pre-quantized; ignoring --quantize" in caplog.text
    assert args.quantize == ""
    assert params["layers"]["mlp"]["w_up"]["kernel"]["q"].dtype == torch.int8


# --- the three CLIs -----------------------------------------------------------------


class StubEncoder:
    """Fixed prompt codes for the JAX model (the port's smoke encoder's)."""

    def __init__(self, codes):
        self.codes = codes

    def encode(self, prompt_id, wav):
        return self.codes


class RecordingDecoder:
    """JAX's AudioDecoder on the port's smoke decoder weights, keeping the
    codes it was asked to decode."""

    def __init__(self, served):
        tree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                      served["decoder"]._params)
        self._dec = japi.AudioDecoder(tree, jv.tiny_vocos_config(), japi.DecoderConfig())
        self.sample_rate, self.token_rate = self._dec.sample_rate, self._dec.token_rate
        self.codes = []

    def decode(self, codes):
        self.codes.append(np.asarray(codes))
        return self._dec.decode(codes)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A small fp32 SpeechLM over the byte tokenizer's vocab exported by the
    JAX package (HF dir), a pre-quantized int8 dir of the same weights
    written by JAX's ``save_quantized_dir``, a seeded 0.5 s prompt wav, the
    port's smoke codec, and the JAX params of each mode as the JAX CLIs
    make them."""
    root = tmp_path_factory.mktemp("quant_serving")
    tok = jtok.build_byte_tokenizer()
    sv = jtok.speech_vocab(tok)
    cfg = _cfg(len(tok))
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    hf_dir, q_dir = str(root / "model"), str(root / "model_int8")
    jhf.save_model_to_hf_dir(params, cfg, hf_dir, eos_token_id=sv.speech_end_id)
    jhf.save_quantized_dir(jq.quantize_llama_params(params), cfg, q_dir, bits=8)
    rng = np.random.default_rng(8)
    t = np.arange(8000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(8000))
    wav_path = str(root / "prompt.wav")
    wavfile.write(wav_path, 16000, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    encoder, decoder = serving_inference.build_codec(
        argparse.Namespace(codec_decoder="", codec_encoder="", device="cpu"))
    fp32, jcfg = jhf.load_serving_model(hf_dir)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    fp32 = jax.tree_util.tree_map(jnp.asarray, fp32)
    jparams = {m: jq.quantize_for_serving(fp32, m) for m in ("int8", "int4-g128")}
    jparams["dir"] = jax.tree_util.tree_map(jnp.asarray, jhf.load_serving_model(q_dir)[0])
    return dict(dirs={"int8": hf_dir, "int4-g128": hf_dir, "dir": q_dir}, wav_path=wav_path,
                encoder=encoder, decoder=decoder, jparams=jparams, jcfg=jcfg, tok=tok, sv=sv)


def _flags(served, mode):
    # on the pre-quantized dir --quantize is given too: ignored with a warning
    return ["--model_dir", served["dirs"][mode], "--quantize",
            "int4" if mode == "dir" else mode, *CPU]


def _prompt_codes(served):
    from tts_max_tpu_torch.data.audio_io import load_wav

    wav = load_wav(served["wav_path"], 16000)[0]
    return np.asarray(served["encoder"].encode(served["wav_path"], wav)).ravel()


def _jax_pcm(served, tokens, with_prompt: bool) -> np.ndarray:
    """The int16 samples the JAX CLIs write for generated ``tokens``: the
    prompt's codes (if any) and the new ones decoded together, the prompt's
    samples skipped, clipped and scaled as JAX's ``save_wav``."""
    prompt = _prompt_codes(served) if with_prompt else np.zeros(0, np.int64)
    codes = np.concatenate([prompt.astype(np.int64),
                            served["sv"].codes_from_tokens(np.asarray(tokens))])
    wav = np.asarray(RecordingDecoder(served).decode(codes), np.float32)[0]
    wav = wav[int(len(prompt) / 50 * 16000):]
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def _jax_engine(served, mode, reqs, max_tokens):
    """Greedy ids of JAX's contiguous engine for request dicts (the CLIs'
    prompt compilation), keyed by request index."""
    tok, sv = served["tok"], served["sv"]
    normalizer = jnorm.create()
    codes = _prompt_codes(served).tolist()
    eng = je.InferenceEngine(served["jparams"][mode], served["jcfg"], max_batch=2,
                             max_len=512, vocab_window=sv.generation_window(),
                             steps_per_dispatch=4, delta_kv=False)
    rids = []
    for r in reqs:
        speech = codes if r.get("prompt_wav") else []
        prompt = jprompting.compile_inference_prompt(
            r.get("prompt_transcript", ""), normalizer.normalize(r["text"]), speech,
            r.get("voice_description", ""), True)
        ids = np.asarray(tok.encode(prompt, add_special_tokens=True), np.int32)
        overrides = {k: r[k] for k in ("temperature", "repetition_penalty") if k in r}
        rids.append(eng.submit(ids, min(max_tokens, r.get("max_tokens", max_tokens)),
                               eos_id=sv.speech_end_id,
                               sampling=js.SamplingParams(**overrides)))
    done = {c.request_id: np.asarray(c.tokens).tolist() for c in eng.run()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("mode", MODES)
def test_serving_inference_quantized_matches_jax(served, mode, tmp_path):
    out = str(tmp_path / "o.wav")
    report = serving_inference.main([
        "--text", TEXT, "--output", out, "--prompt_wav", served["wav_path"],
        "--prompt_transcript", TRANSCRIPT, "--temperature", "0", "--max_tokens", "12",
        *_flags(served, mode)])
    ours = report["result"]
    codes = _prompt_codes(served)
    decoder = RecordingDecoder(served)
    jmodel = jsyn.LocalTtsModel(served["jparams"][mode], served["jcfg"], served["tok"],
                                served["sv"], StubEncoder(codes), decoder)
    ref = jmodel.synthesize_speech(
        jsyn.InferenceSettings(temperature=0.0, max_tokens=12, seed=42),
        text_to_synthesize=TEXT, prompt_id=served["wav_path"], prompt_wav=None,
        audio_prompt_transcription=TRANSCRIPT)
    [jax_codes] = decoder.codes
    assert 0 < ours.decode_steps <= 12 and len(ours.speech_codes) > 0
    np.testing.assert_array_equal(ours.speech_codes, jax_codes[len(codes):])
    assert ours.wav.shape == ref.wav.shape
    np.testing.assert_allclose(ours.wav, ref.wav, atol=1e-4)
    sr, data = wavfile.read(out)
    assert sr == 16000 and len(data) == ours.wav.shape[1]


@pytest.mark.parametrize("mode", MODES)
def test_serve_batch_quantized_matches_jax(served, mode, tmp_path):
    reqs = [dict(text=TEXT, prompt_wav=served["wav_path"], prompt_transcript=TRANSCRIPT,
                 temperature=0.0),
            dict(text="A calm day by the sea.", voice_description="a low calm voice",
                 temperature=0.0, max_tokens=9),
            dict(text="Short one.", temperature=0.0, repetition_penalty=1.3)]
    with open(tmp_path / "reqs.jsonl", "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")
    report = serve_batch.main([
        "--requests", str(tmp_path / "reqs.jsonl"), "--out_dir", str(tmp_path / "wavs"),
        "--max_batch", "2", "--max_len", "512", "--max_tokens", "12",
        "--steps_per_dispatch", "4", *_flags(served, mode)])
    ours = {c.request_id: c.tokens.tolist() for c in report["completions"]}
    assert [ours[i] for i in range(3)] == _jax_engine(served, mode, reqs, 12)
    for i, path in report["outputs"].items():
        sr, data = wavfile.read(path)
        pcm = _jax_pcm(served, ours[i], bool(reqs[i].get("prompt_wav")))
        assert sr == 16000 and len(data) == len(pcm)
        assert np.abs(data.astype(np.int32) - pcm).max() <= 2


@pytest.mark.parametrize("mode", MODES)
def test_serve_http_quantized_matches_jax(served, mode):
    args = serve_http.parse_args(["--max_batch", "2", "--max_len", "512", "--max_tokens", "10",
                                  "--steps_per_dispatch", "4", *_flags(served, mode)])
    server = serve_http.build_server(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    body = {"text": TEXT, "prompt_wav": served["wav_path"], "prompt_transcript": TRANSCRIPT,
            "temperature": 0.0, "max_tokens": 10}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("POST", "/generate", body=json.dumps(body))
        gen = json.loads(conn.getresponse().read())
        conn.request("POST", "/synthesize", body=json.dumps(body))
        data = conn.getresponse().read()
        conn.close()
    finally:
        httpd.shutdown()
        server.shutdown()
        thread.join(timeout=5)
    [ref] = _jax_engine(served, mode, [body], 10)
    assert gen["tokens"] == ref and len(ref) > 0
    n_pcm = struct.unpack("<I", data[40:44])[0]
    pcm = np.frombuffer(data[44:], dtype="<i2")
    want = _jax_pcm(served, ref, True)
    assert n_pcm == 2 * len(pcm) and len(pcm) == len(want)
    assert np.abs(pcm.astype(np.int32) - want).max() <= 2
