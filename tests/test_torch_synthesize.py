"""End to end: the port's ``LocalTtsModel.synthesize_speech`` against the
JAX package's on the same converted weights, greedy, fp32, with a stub
encoder returning the same prompt codes: identical speech ids, the wav
within 1e-4, and no prompt encoding in voice-description mode. Then the
real prompt encoders of both packages (``AudioEncoder``: w2v-bert features
and layers, the acoustic encoder, FSQ) on a prompt wav: identical codes,
and identical greedy speech ids through ``synthesize_speech`` and
``complete_prompt``. Also: every entry point defaults to CUDA and, on a
machine without it, raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu.inference import synthesize as jsyn
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models.codec import api as japi
from tts_max_tpu.models.codec import encoder as jenc
from tts_max_tpu.models.codec import vocos as jv
from tts_max_tpu.models.codec import w2vbert as jw
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core import tokenization as ttok
from tts_max_tpu_torch.inference import generate as tg
from tts_max_tpu_torch.inference import synthesize as tsyn
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models.codec import api as tapi
from tts_max_tpu_torch.models.codec import encoder as tenc
from tts_max_tpu_torch.models.codec import vocos as tv
from tts_max_tpu_torch.models.codec import w2vbert as tw
from tts_max_tpu_torch.ops import sampling as ts


class StubEncoder:
    """The same seeded prompt codes for both packages."""

    def __init__(self):
        self.codes = np.random.default_rng(0).integers(0, 65536, 30)
        self.calls = 0

    def encode(self, prompt_id, wav):
        self.calls += 1
        return self.codes


@pytest.fixture(scope="module")
def pipelines():
    tok = jtok.build_byte_tokenizer()
    ttk = ttok.build_byte_tokenizer()
    assert len(tok) == len(ttk)
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=len(tok), max_seq_len=512),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=len(ttk), max_seq_len=512),
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jvc, tvc = jv.tiny_vocos_config(), tv.tiny_vocos_config()
    jd = jv.init_decoder(jax.random.PRNGKey(1), jvc)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jmodel = jsyn.LocalTtsModel(
        jp, jcfg, tok, jtok.speech_vocab(tok), StubEncoder(),
        japi.AudioDecoder(jd, jvc, japi.DecoderConfig()))
    tmodel = tsyn.LocalTtsModel(
        convert.llama_from_numpy(to_np(jp), tcfg, device="cpu"), tcfg, ttk,
        ttok.speech_vocab(ttk), StubEncoder(),
        tapi.AudioDecoder(convert.vocos_from_numpy(to_np(jd), tvc, device="cpu"),
                          tvc, tapi.DecoderConfig(), device="cpu"),
        device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("mode", ["prompt_audio", "voice_description"])
def test_synthesize_speech_matches_jax(pipelines, mode):
    jmodel, tmodel = pipelines
    kw = dict(text_to_synthesize="Hello there, 42 friends!", prompt_id="p1",
              prompt_wav=np.zeros(9600, np.float32),
              audio_prompt_transcription="reference speech")
    if mode == "voice_description":
        kw.update(voice_description="a calm narrator", enable_instruction=False)
    js = jsyn.InferenceSettings(temperature=0.0, max_tokens=14, min_tokens=4)
    tset = tsyn.InferenceSettings(temperature=0.0, max_tokens=14, min_tokens=4)
    ref = jmodel.synthesize_speech(js, **kw)
    calls = tmodel._audio_encoder.calls
    ours = tmodel.synthesize_speech(tset, **kw)
    # identical speech ids decode to the same wav; a differing id would move
    # a 320-sample frame far more than 1e-4
    assert ours.wav.shape == ref.wav.shape and ours.wav.shape[1] % 320 == 0
    np.testing.assert_allclose(ours.wav, ref.wav, atol=1e-4)
    if mode == "voice_description":
        assert ours.encoding_time == 0.0 and tmodel._audio_encoder.calls == calls
    else:
        assert ours.encoding_time > 0.0
    assert 0 < ours.decode_steps <= 14


def test_generated_speech_ids_match_jax(pipelines):
    """The speech ids themselves, through the models' generators."""
    jmodel, tmodel = pipelines
    ids = np.asarray(tmodel._tokenizer.encode("hi <|speech_start|>",
                                              add_special_tokens=True), np.int32)
    js = jsyn.InferenceSettings(temperature=0.0, max_tokens=10)
    tset = tsyn.InferenceSettings(temperature=0.0, max_tokens=10)
    ref = jmodel._generate(ids, js)
    ours, _ = tmodel._generate(ids, tset)
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def encoders():
    """Tiny codec encoders of both packages on the same weights: a tiny
    w2v-bert over the real 160 features, and a tiny encoder whose conv
    kernels are x10 and SnakeBeta parameters random, so that the codes
    vary."""
    pytest.importorskip("transformers")  # the JAX package's features need it
    wcfg = {**jw.tiny_w2vbert_config().__dict__, "feature_dim": 160}
    jwc, twc = jw.W2VBertConfig(**wcfg), tw.W2VBertConfig(**wcfg)
    ecfg = {**jenc.tiny_encoder_config().__dict__, "semantic_input_dim": jwc.hidden_size}
    jec = jenc.EncoderConfig(**ecfg)
    tec = tenc.EncoderConfig(**{**ecfg, "fsq": tenc.fsq.FSQConfig(dim=jec.fsq.dim)})
    # weights drawn by the port (JAX's init compiles for ~30 s on the CPU),
    # handed to both packages as numpy
    wp = jax.tree_util.tree_map(lambda t: t.numpy(), tw.init_params(twc, seed=5, device="cpu"))
    rng = np.random.default_rng(6)

    def livelier(path, x):
        if path[-1].key in ("alpha", "beta"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        return x * 10 if path[-1].key == "kernel" and x.ndim == 3 else x

    ep = jax.tree_util.tree_map_with_path(
        livelier, jax.tree_util.tree_map(lambda t: t.numpy(),
                                         tenc.init_encoder(tec, seed=7, device="cpu")))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jenc_ = japi.AudioEncoder(to_j(ep), jec, jw.default_semantic_fn(params=to_j(wp), cfg=jwc))
    tenc_ = tapi.AudioEncoder(
        convert.encoder_from_numpy(to_np(ep), tec, device="cpu"), tec,
        tw.default_semantic_fn(params=convert.w2vbert_from_numpy(to_np(wp), twc, device="cpu"),
                               cfg=twc, device="cpu"), device="cpu")
    return jenc_, tenc_


def _prompt_wav(n=8000, seed=8):
    """Half a second of a seeded tone-plus-noise prompt."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_audio_encoder_codes_match_jax(encoders):
    jenc_, tenc_ = encoders
    wav = _prompt_wav()
    ref = jenc_.encode(wav)
    got = tenc_.encode(wav)
    assert got.shape == ref.shape == (26,) and got.dtype == np.int32
    assert len(np.unique(ref)) > 5
    np.testing.assert_array_equal(got, ref)
    batch = np.stack([wav, _prompt_wav(seed=9)])
    np.testing.assert_array_equal(tenc_.encode(batch), jenc_.encode(batch))


def test_synthesis_from_a_prompt_wav_matches_jax(pipelines, encoders):
    """Greedy speech ids identical through both packages' real encoders."""
    jmodel, tmodel = pipelines
    jenc_, tenc_ = encoders
    jm = jsyn.LocalTtsModel(jmodel._params, jmodel._cfg, jmodel._tokenizer, jmodel._sv,
                            japi.CachingAudioEncoder(jenc_), jmodel._audio_decoder)
    tm = tsyn.LocalTtsModel(tmodel._params, tmodel._cfg, tmodel._tokenizer, tmodel._sv,
                            tapi.CachingAudioEncoder(tenc_), tmodel._audio_decoder, device="cpu")
    kw = dict(text_to_synthesize="Hello there, 42 friends!", prompt_id="p1",
              prompt_wav=_prompt_wav(), audio_prompt_transcription="reference speech")
    ref = jm.synthesize_speech(jsyn.InferenceSettings(temperature=0.0, max_tokens=12,
                                                      min_tokens=4), **kw)
    ours = tm.synthesize_speech(tsyn.InferenceSettings(temperature=0.0, max_tokens=12,
                                                       min_tokens=4), **kw)
    np.testing.assert_array_equal(tm._audio_encoder.encode("p1", None),
                                  jm._audio_encoder.encode("p1", None))
    # identical ids decode to the same wav; one differing id moves a 320-sample
    # frame far more than 1e-4
    assert ours.wav.shape == ref.wav.shape and ours.encoding_time > 0.0
    np.testing.assert_allclose(ours.wav, ref.wav, atol=1e-4)
    js = jsyn.InferenceSettings(temperature=0.0, max_tokens=6)
    ts_ = tsyn.InferenceSettings(temperature=0.0, max_tokens=6)
    np.testing.assert_allclose(tm.complete_prompt(_prompt_wav(seed=10), ts_),
                               jm.complete_prompt(_prompt_wav(seed=10), js), atol=1e-4)


def _entry_points():
    cfg = tl.tiny_config()
    vcfg = tv.tiny_vocos_config()
    ecfg, wcfg = tenc.tiny_encoder_config(), tw.tiny_w2vbert_config()
    return {
        "init_encoder": lambda: tenc.init_encoder(ecfg),
        "w2vbert_init_params": lambda: tw.init_params(wcfg),
        "encoder_from_numpy": lambda: convert.encoder_from_numpy({}, ecfg),
        "w2vbert_from_numpy": lambda: convert.w2vbert_from_numpy({}, wcfg),
        "AudioEncoder": lambda: tapi.AudioEncoder({}, ecfg, None),
        "create_encoder": lambda: tapi.create_encoder(params={}, semantic_fn=lambda w: w),
        "default_semantic_fn": lambda: tw.default_semantic_fn(params={}),
        "init_params": lambda: tl.init_params(cfg),
        "init_kv_cache": lambda: tl.init_kv_cache(cfg, 1, 8),
        "init_decoder": lambda: tv.init_decoder(vcfg),
        "llama_from_numpy": lambda: convert.llama_from_numpy({}, cfg),
        "vocos_from_numpy": lambda: convert.vocos_from_numpy({}, vcfg),
        "AudioDecoder": lambda: tapi.AudioDecoder({}, vcfg, tapi.DecoderConfig()),
        "create_decoder": lambda: tapi.create_decoder(params={}),
        "LocalTtsModel": lambda: tsyn.LocalTtsModel({}, cfg, None, None, None, None),
        "generate": lambda: tg.generate({}, cfg, np.zeros((1, 4), np.int32), [4], None,
                                        sp=ts.SamplingParams(), max_new_tokens=2,
                                        eos_id=-1),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the CUDA default is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()
