"""The port's serving entry points on the CPU (``--device cpu``), on a tiny
model exported to an HF directory by the JAX package, against the JAX
package's ``LocalTtsModel`` and contiguous engine on the same directory.

The CLIs run their codec in smoke mode (seeded tiny decoder and encoder);
the JAX side is handed the same codec (the port's smoke decoder parameters,
and the prompt codes of the port's smoke encoder), so that what is compared
is the SpeechLM path from the directory: greedy speech ids must be equal.
Also: the HTTP server answers, streams and reports, the streaming decoder
agrees with JAX's chunk by chunk, the prefill-ahead flags reach the engine,
and the flag the port does not take fails in argparse."""

import argparse
import dataclasses
import http.client
import json
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
from tts_max_tpu.inference import streaming as jstream
from tts_max_tpu.inference import synthesize as jsyn
from tts_max_tpu.models import hf_import as jhf
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models.codec import api as japi
from tts_max_tpu.models.codec import vocos as jv
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core import tokenization as ttok
from tts_max_tpu_torch.inference import engine as te
from tts_max_tpu_torch.inference import streaming as tstream
from tts_max_tpu_torch.models import hf_import as thf
from tts_max_tpu_torch.models.codec import api as tapi
from tts_max_tpu_torch.models.codec import vocos as tv
from tts_max_tpu_torch.tools import serve_batch, serve_http, serving_inference

CPU = ["--device", "cpu", "--dtype", "float32"]
TEXT = "Hello there, 42 friends!"
TRANSCRIPT = "reference speech"


class StubEncoder:
    """Fixed prompt codes for the JAX model (the port's smoke encoder's)."""

    def __init__(self, codes):
        self.codes = codes

    def encode(self, prompt_id, wav):
        return self.codes


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny fp32 SpeechLM over the byte tokenizer's vocab, exported by the
    JAX package; a seeded 0.5 s prompt wav; the port's smoke codec."""
    root = tmp_path_factory.mktemp("serving")
    tok = jtok.build_byte_tokenizer()
    cfg = dataclasses.replace(jl.tiny_config(vocab_size=len(tok), max_seq_len=512),
                              dtype=jnp.float32)
    model_dir = str(root / "model")
    jhf.save_model_to_hf_dir(jl.init_params(jax.random.PRNGKey(0), cfg), cfg, model_dir,
                             eos_token_id=jtok.speech_vocab(tok).speech_end_id)
    rng = np.random.default_rng(8)
    t = np.arange(8000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(8000))
    wav_path = str(root / "prompt.wav")
    wavfile.write(wav_path, 16000, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    encoder, decoder = serving_inference.build_codec(
        argparse.Namespace(codec_decoder="", codec_encoder="", device="cpu"))
    params, jcfg = jhf.load_serving_model(model_dir)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    return dict(root=root, model_dir=model_dir, wav_path=wav_path, encoder=encoder,
                decoder=decoder, jparams=jax.tree_util.tree_map(jnp.asarray, params),
                jcfg=jcfg, tok=tok, sv=jtok.speech_vocab(tok))


def _prompt_codes(served):
    from tts_max_tpu_torch.data.audio_io import load_wav

    wav = load_wav(served["wav_path"], 16000)[0]
    return np.asarray(served["encoder"].encode(served["wav_path"], wav)).ravel()


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


def test_serving_inference_matches_jax_local_tts_model(served, tmp_path):
    out = str(tmp_path / "o.wav")
    report = serving_inference.main([
        "--model_dir", served["model_dir"], "--text", TEXT, "--output", out,
        "--prompt_wav", served["wav_path"], "--prompt_transcript", TRANSCRIPT,
        "--temperature", "0", "--max_tokens", "12", *CPU])
    ours = report["result"]
    codes = _prompt_codes(served)
    assert len(codes) == 26
    decoder = RecordingDecoder(served)
    jmodel = jsyn.LocalTtsModel(served["jparams"], served["jcfg"], served["tok"],
                                served["sv"], StubEncoder(codes), decoder)
    ref = jmodel.synthesize_speech(
        jsyn.InferenceSettings(temperature=0.0, max_tokens=12, seed=42),
        text_to_synthesize=TEXT, prompt_id=served["wav_path"], prompt_wav=None,
        audio_prompt_transcription=TRANSCRIPT)
    assert 0 < ours.decode_steps <= 12
    # the generated speech ids, and the wav they decode to
    [jax_codes] = decoder.codes
    assert len(ours.speech_codes) > 0
    np.testing.assert_array_equal(ours.speech_codes, jax_codes[len(codes):])
    assert ours.wav.shape == ref.wav.shape
    np.testing.assert_allclose(ours.wav, ref.wav, atol=1e-4)
    sr, data = wavfile.read(out)
    assert sr == 16000 and data.dtype == np.int16 and len(data) == ours.wav.shape[1]
    assert report["load_s"] > 0


def _jsonl(served, path):
    reqs = [
        dict(text=TEXT, prompt_wav=served["wav_path"], prompt_transcript=TRANSCRIPT,
             temperature=0.0),
        dict(text="A calm day by the sea.", voice_description="a low calm voice",
             temperature=0.0, max_tokens=9),
        dict(text="Short one.", temperature=0.0, repetition_penalty=1.3),
    ]
    with open(path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")
    return reqs


def test_serve_batch_matches_the_jax_contiguous_engine(served, tmp_path):
    """Three JSONL requests (a prompt wav, a voice description, plain text;
    per-request greedy sampling) through a 2-slot contiguous pool, whose
    decode runs kernel C's plain version here: the greedy tokens of JAX's
    contiguous engine (``delta_kv=False``) on the same directory."""
    reqs = _jsonl(served, tmp_path / "reqs.jsonl")
    report = serve_batch.main([
        "--model_dir", served["model_dir"], "--requests", str(tmp_path / "reqs.jsonl"),
        "--out_dir", str(tmp_path / "wavs"), "--max_batch", "2", "--max_len", "512",
        "--max_tokens", "12", "--steps_per_dispatch", "4", *CPU])
    ours = {c.request_id: c.tokens.tolist() for c in report["completions"]}
    assert sorted(report["outputs"]) == [0, 1, 2]
    for path in report["outputs"].values():
        sr, data = wavfile.read(path)
        assert sr == 16000 and len(data) % 320 == 0
    assert isinstance(report["engine"], te.InferenceEngine)

    tok, sv = served["tok"], served["sv"]
    normalizer = jnorm.create()
    codes = _prompt_codes(served).tolist()
    jeng = je.InferenceEngine(served["jparams"], served["jcfg"], max_batch=2, max_len=512,
                              vocab_window=sv.generation_window(), steps_per_dispatch=4,
                              delta_kv=False)
    rids = []
    for r in reqs:
        speech = codes if r.get("prompt_wav") else []
        prompt = jprompting.compile_inference_prompt(
            r.get("prompt_transcript", ""), normalizer.normalize(r["text"]), speech,
            r.get("voice_description", ""), True)
        ids = np.asarray(tok.encode(prompt, add_special_tokens=True), np.int32)
        overrides = {k: r[k] for k in ("temperature", "repetition_penalty") if k in r}
        rids.append(jeng.submit(ids, min(12, r.get("max_tokens", 12)),
                                eos_id=sv.speech_end_id,
                                sampling=js.SamplingParams(**overrides)))
    ref = {c.request_id: np.asarray(c.tokens).tolist() for c in jeng.run()}
    assert [ours[i] for i in range(3)] == [ref[r] for r in rids]
    assert len(ours[1]) <= 9


@pytest.fixture(scope="module")
def http_server(served):
    args = serve_http.parse_args(["--model_dir", served["model_dir"], "--max_batch", "2",
                                  "--max_len", "512", "--max_tokens", "10",
                                  "--steps_per_dispatch", "4", *CPU])
    server = serve_http.build_server(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield server, httpd.server_address[1]
    httpd.shutdown()
    server.shutdown()
    thread.join(timeout=5)


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()  # http.client undoes the chunked framing
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_http_server_synthesizes_streams_and_reports(http_server, served):
    server, port = http_server
    assert isinstance(server.engine, te.InferenceEngine)
    body = {"text": TEXT, "prompt_wav": served["wav_path"],
            "prompt_transcript": TRANSCRIPT, "seed": 7, "max_tokens": 10}
    status, ctype, data = _call(port, "POST", "/synthesize", body)
    assert status == 200 and ctype == "audio/wav"
    assert data[:4] == b"RIFF" and data[8:16] == b"WAVEfmt "
    n_pcm = struct.unpack("<I", data[40:44])[0]
    assert n_pcm == len(data) - 44 and n_pcm % 640 == 0
    status, ctype, streamed = _call(port, "POST", "/stream", {**body, "chunk_codes": 3,
                                                              "context_codes": 5})
    assert status == 200 and ctype == "audio/wav"
    assert streamed[:4] == b"RIFF" and struct.unpack("<I", streamed[40:44])[0] == 0xFFFFFFFF
    # the same request (same seed: the same tokens) streamed adds up to as
    # many samples as the whole wav
    assert len(streamed) - 44 == n_pcm
    status, _, gen = _call(port, "POST", "/generate", body)
    gen = json.loads(gen)
    assert status == 200 and 0 < len(gen["tokens"]) <= 10
    assert len(gen["codes"]) * 640 == n_pcm
    status, _, stats = _call(port, "GET", "/stats")
    stats = json.loads(stats)
    assert status == 200 and stats["completed_requests"] >= 3
    assert stats["max_batch"] == 2 and stats["active_slots"] == 0
    assert _call(port, "GET", "/health")[0] == 200
    assert _call(port, "POST", "/synthesize", {"seed": 1})[0] == 400
    assert _call(port, "GET", "/nope")[0] == 404


def test_streaming_decoder_matches_jax_chunk_by_chunk():
    jcfg, tcfg = jv.tiny_vocos_config(), tv.tiny_vocos_config()
    jp = jv.init_decoder(jax.random.PRNGKey(1), jcfg)
    jdec = japi.AudioDecoder(jp, jcfg, japi.DecoderConfig())
    tdec = tapi.AudioDecoder(convert.vocos_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                                      tcfg, device="cpu"),
                             tcfg, tapi.DecoderConfig(), device="cpu")
    rng = np.random.default_rng(3)
    history = rng.integers(0, 65536, 9)
    pieces = [rng.integers(0, 65536, n) for n in (2, 7, 1, 13, 4, 9)]
    ref = jstream.StreamingDecoder(jdec, chunk_codes=5, context_codes=6, history=history)
    ours = tstream.StreamingDecoder(tdec, chunk_codes=5, context_codes=6, history=history)
    n_out = 0
    for p in pieces:
        a, b = ours.push(p), ref.push(p)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4)
        n_out += len(a)
    a, b = ours.flush(), ref.flush()
    np.testing.assert_allclose(a, b, atol=1e-4)
    assert n_out + len(a) == sum(map(len, pieces)) * 320


def test_streaming_synthesizer_emits_the_decoder_stream(served):
    """Over the port's contiguous engine (greedy): the chunks it yields are
    those a StreamingDecoder gives for the request's final codes."""
    params, cfg = thf.load_serving_model(served["model_dir"], device="cpu",
                                         dtype=torch.float32)
    tok = ttok.build_byte_tokenizer()
    sv = ttok.speech_vocab(tok)
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    eng = te.InferenceEngine(params, cfg, max_batch=2, max_len=256, device="cpu",
                             sp=SamplingParams(temperature=0.0), steps_per_dispatch=4,
                             vocab_window=sv.generation_window())
    synth = tstream.StreamingSynthesizer(eng, tok, sv, served["decoder"], chunk_codes=3,
                                         context_codes=4)
    ids = np.asarray(tok.encode("hi <|speech_start|>", add_special_tokens=True), np.int32)
    chunks = list(synth.stream("", max_new_tokens=14, input_ids=ids))
    ref_eng = te.InferenceEngine(params, cfg, max_batch=2, max_len=256, device="cpu",
                                 sp=SamplingParams(temperature=0.0), steps_per_dispatch=4,
                                 vocab_window=sv.generation_window())
    [done] = ref_eng.generate_all([ids], max_new_tokens=14, eos_id=sv.speech_end_id)
    codes = sv.codes_from_tokens(done.tokens)
    sd = tstream.StreamingDecoder(served["decoder"], 3, 4)
    want = np.concatenate([sd.push(codes), sd.flush()])
    got = np.concatenate(chunks)
    assert len(chunks) > 1 and len(got) == len(codes) * 320
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cli,flag", [
    (serve_batch, ["--no_staged_cache"]),
])
def test_flags_the_port_does_not_take_fail_in_argparse(cli, flag, tmp_path):
    argv = ["--model_dir", str(tmp_path), "--text", "x", "--output", "o.wav",
            "--requests", "r.jsonl", "--out_dir", str(tmp_path), *CPU]
    if cli is not serving_inference:
        argv = [a for a in argv if a not in ("--text", "x", "--output", "o.wav")]
    if cli is serve_http:
        argv = [a for a in argv if a not in ("--requests", "r.jsonl", "--out_dir",
                                             str(tmp_path))]
    with pytest.raises(SystemExit) as e:
        (cli.parse_args if cli is serve_http else cli.main)(argv + flag)
    assert e.value.code == 2


@pytest.mark.parametrize("cli", [serve_batch, serve_http])
@pytest.mark.parametrize("flag,want", [
    ([], 16), (["--steps_per_dispatch", "0"], 16), (["--steps_per_dispatch", "8"], 8),
    (["--prefill_ahead"], 32), (["--prefill_ahead", "--steps_per_dispatch", "0"], 32),
    (["--prefill_ahead", "--steps_per_dispatch", "8"], 8)])
def test_steps_per_dispatch_zero_means_auto(served, cli, flag, want):
    """``--steps_per_dispatch 0``, the reference CLIs' default, means auto:
    16 steps per dispatch, or 32 with ``--prefill_ahead``, as in the
    reference; an explicit K stays K."""
    argv = ["--model_dir", served["model_dir"], "--no_warmup", *CPU, *flag]
    if cli is serve_batch:
        argv += ["--requests", "r.jsonl", "--out_dir", "wavs"]
    args = cli.parse_args(argv)
    k = flag.index("--steps_per_dispatch") + 1 if "--steps_per_dispatch" in flag else None
    assert args.steps_per_dispatch == (int(flag[k]) if k else 0)
    params, cfg, _ = serving_inference.load_model(args)
    sv = ttok.speech_vocab(ttok.build_byte_tokenizer())
    engine = serve_batch.build_engine(args, params, cfg, sv, prefix_cache=False)
    assert isinstance(engine, te.InferenceEngine)
    assert engine.steps_per_dispatch == want
    assert engine.prefill_ahead == ("--prefill_ahead" in flag)


@pytest.mark.parametrize("cli", [serve_batch, serve_http])
@pytest.mark.parametrize("engine_kind", ["contiguous", "paged"])
@pytest.mark.parametrize("flag,want", [
    (["--prefill_ahead"], (2, 512, 0)),
    (["--prefill_ahead", "--park_rows", "3", "--park_len", "200",
      "--park_groups_per_poll", "2"], (3, 192, 2)),
    (["--park_rows", "3"], None),
], ids=["defaults", "explicit", "off"])
def test_park_flags_reach_the_engine(served, cli, engine_kind, flag, want):
    """``--prefill_ahead`` and ``--park_*`` reach ``build_engine``'s engine
    (park rows, park length floored to the 64-token bucket step, groups per
    poll); without ``--prefill_ahead`` the engine parks nothing."""
    argv = ["--model_dir", served["model_dir"], "--no_warmup", "--max_batch", "2",
            "--max_len", "512", "--engine", engine_kind, *CPU, *flag]
    if cli is serve_batch:
        argv += ["--requests", "r.jsonl", "--out_dir", "wavs"]
    args = cli.parse_args(argv)
    params, cfg, _ = serving_inference.load_model(args)
    sv = ttok.speech_vocab(ttok.build_byte_tokenizer())
    engine = serve_batch.build_engine(args, params, cfg, sv, prefix_cache=True)
    assert isinstance(engine, te.PagedInferenceEngine) == (engine_kind == "paged")
    if want is None:
        assert not engine.prefill_ahead and "park_rows" not in engine.stats()
        return
    assert (engine.park_rows, engine.park_len, engine.park_groups_per_poll) == want
    assert engine.stats()["free_park_rows"] == want[0]


def test_serve_batch_prefill_ahead_gives_the_same_ids(served, tmp_path):
    """The JSONL of ``test_serve_batch_matches_the_jax_contiguous_engine``
    through a one-slot pool with ``--prefill_ahead``: two requests park, and
    the greedy ids equal the run without it."""
    _jsonl(served, tmp_path / "reqs.jsonl")
    runs = []
    for extra in ([], ["--prefill_ahead", "--park_rows", "2"]):
        runs.append(serve_batch.main([
            "--model_dir", served["model_dir"], "--requests", str(tmp_path / "reqs.jsonl"),
            "--out_dir", str(tmp_path / f"wavs{len(runs)}"), "--max_batch", "1",
            "--max_len", "512", "--max_tokens", "12", "--steps_per_dispatch", "4", *CPU,
            *extra]))
    plain, parked = ({c.request_id: c.tokens.tolist() for c in r["completions"]}
                     for r in runs)
    assert parked == plain and sorted(runs[1]["outputs"]) == [0, 1, 2]
    stats = runs[1]["engine"].stats()
    assert stats["parked_total"] == 2 and stats["free_park_rows"] == 2
    assert len(runs[1]["ttft_s"]) == 3


def test_clis_default_to_the_card(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        serving_inference.main(["--model_dir", served["model_dir"], "--text", "x",
                                "--output", str(tmp_path / "o.wav")])
    assert serve_http.parse_args(["--model_dir", "m"]).device == "cuda"


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.float32])
def test_audio_io_matches_jax(dtype, tmp_path):
    """``load_wav`` of a stereo 24 kHz file (mono-ized, resampled to 16 kHz)
    and ``save_wav`` give the JAX package's arrays and bytes."""
    from tts_max_tpu.data import audio_io as jio
    from tts_max_tpu_torch.data import audio_io as tio

    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (2400, 2))
    scale = {np.int16: 32767, np.int32: 2 ** 31 - 1, np.uint8: 127, np.float32: 1}[dtype]
    data = (x * scale + (128 if dtype is np.uint8 else 0)).astype(dtype)
    path = str(tmp_path / "in.wav")
    wavfile.write(path, 24000, data)
    for rate in (None, 16000):
        ours, sr = tio.load_wav(path, rate)
        ref, rsr = jio.load_wav(path, rate)
        assert sr == rsr and ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    tio.save_wav(str(tmp_path / "a.wav"), ours, 16000)
    jio.save_wav(str(tmp_path / "b.wav"), ref, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def test_http_server_under_concurrent_requests(http_server):
    """More client threads than the pool has slots, with a short switch
    interval: every request completes, a seed gives the same tokens however
    the requests interleave (slot isolation), and ``/stats`` counts them
    all."""
    import sys

    server, port = http_server
    before = server.stats()["completed_requests"]
    bodies = [{"text": f"line {i % 3}", "seed": i % 3, "max_tokens": 6} for i in range(9)]
    results = [None] * len(bodies)

    def run(i):
        results[i] = _call(port, "POST", "/generate", bodies[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    tokens = [json.loads(r[2])["tokens"] for r in results if r and r[0] == 200]
    assert len(tokens) == len(bodies)
    for i in range(3):
        assert tokens[i] == tokens[i + 3] == tokens[i + 6]
    stats = server.stats()
    assert stats["completed_requests"] - before == len(bodies)
    assert stats["active_slots"] == 0 and stats["queued_requests"] == 0
