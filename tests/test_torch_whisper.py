"""The port's Whisper (``tts_max_tpu_torch/models/whisper.py``) and its ASR
backend (``training/rlhf/asr.py``) against the JAX package's on the CPU, in
fp32, at a tiny Whisper whose vocabulary is the committed Whisper-shaped
fixture tokenizer's (``tests/fixtures/whisper_style_tokenizer``, written
by ``make_whisper_style_tokenizer.py``): the HF importer on a
``transformers`` Whisper state dict (the trees equal JAX's), the log-mel
within 1e-5, encoder states and decoder logits within 1e-4, greedy tokens
and lengths identical, the port's Whisper tokenizer reader against
``transformers``' ``WhisperTokenizer`` and ``WhisperTokenizerFast``
(language map, task ids, 200 random id sequences decoded), and
``load_transcriber`` on an HF dir against JAX's (identical transcripts,
the call counters)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models import whisper as jwhisper
from tts_max_tpu.training.rlhf import asr as jasr
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import safetensors_io, whisper
from tts_max_tpu_torch.training.rlhf import asr

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "whisper_style_tokenizer")
TOL = 1e-4


def _cfg():
    """A tiny Whisper over the fixture tokenizer's 620 ids."""
    tok = asr.WhisperTokenizer(FIXTURE)
    return whisper.WhisperConfig(
        n_mels=16, vocab_size=len(tok), d_model=32, encoder_layers=2, decoder_layers=2,
        num_heads=4, ffn_dim=64, max_source_positions=24, max_target_positions=32,
        decoder_start_token_id=tok.convert_tokens_to_ids("<|startoftranscript|>"),
        eos_token_id=tok.convert_tokens_to_ids("<|endoftext|>"))


def _hf_config(cfg):
    from transformers import WhisperConfig as HFWhisperConfig

    return HFWhisperConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.n_mels, d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.num_heads, decoder_attention_heads=cfg.num_heads,
        encoder_ffn_dim=cfg.ffn_dim, decoder_ffn_dim=cfg.ffn_dim,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        decoder_start_token_id=cfg.decoder_start_token_id, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.eos_token_id, bos_token_id=cfg.eos_token_id,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(cfg, port params, JAX params, HF dir): a seeded transformers Whisper
    whose weights both importers read; the dir holds them as safetensors
    beside the fixture tokenizer."""
    from transformers import WhisperForConditionalGeneration

    cfg = _cfg()
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(_hf_config(cfg)).eval()
    with torch.no_grad():  # biases and norms away from their init, so they count
        for name, p in model.named_parameters():
            if name.endswith("bias") or "layer_norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    sd = model.state_dict()
    d = tmp_path_factory.mktemp("whisper")
    safetensors_io.save_file({k: v.contiguous() for k, v in sd.items()
                              if k != "proj_out.weight"}, str(d / "model.safetensors"))
    model.config.to_json_file(str(d / "config.json"))
    for name in os.listdir(FIXTURE):
        (d / name).write_bytes(open(os.path.join(FIXTURE, name), "rb").read())
    ours = whisper.import_hf_state_dict(sd, cfg, device="cpu")
    theirs = jwhisper.import_hf_state_dict(sd, jwhisper.WhisperConfig(
        **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}))
    return cfg, ours, theirs, str(d)


def _jcfg(cfg):
    return jwhisper.WhisperConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _mel(cfg, batch=2):
    rng = np.random.default_rng(0)
    return rng.standard_normal((batch, 2 * cfg.max_source_positions, cfg.n_mels)
                               ).astype(np.float32)


def test_hf_importer_matches_jax(pair):
    """Every leaf of the imported tree equals JAX's import of the same
    state dict, and ``convert.whisper_from_numpy`` carries JAX's tree over
    unchanged."""
    cfg, ours, theirs, _ = pair
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    carried = convert.whisper_from_numpy(jax.tree.map(np.asarray, theirs), cfg, device="cpu")
    for path, leaf in flat_t:
        keys = [p.key for p in path]
        a, b = ours, carried
        for k in keys:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf), err_msg=str(keys))
        np.testing.assert_array_equal(b.numpy(), np.asarray(leaf), err_msg=str(keys))
    assert len(flat_t) == len(jax.tree.leaves(jax.tree.map(
        lambda t: 0, ours, is_leaf=lambda t: isinstance(t, torch.Tensor))))


def test_log_mel_matches_jax():
    wav = (np.random.default_rng(2).standard_normal((2, 7680)) * 0.1).astype(np.float32)
    for n_mels in (16, 128):
        got = whisper.log_mel_spectrogram(torch.from_numpy(wav), n_mels).numpy()
        want = np.asarray(jwhisper.log_mel_spectrogram(jnp.asarray(wav), n_mels))
        assert got.shape == want.shape == (2, 48, n_mels)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_encoder_and_decoder_logits_match_jax(pair):
    cfg, ours, theirs, _ = pair
    mel = _mel(cfg)
    enc = whisper.encode(ours, cfg, torch.from_numpy(mel))
    jenc = jwhisper.encode(theirs, _jcfg(cfg), jnp.asarray(mel))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=TOL, rtol=TOL)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7))
    got = whisper.decoder_forward(ours, cfg, torch.from_numpy(tokens), enc)
    want = jwhisper.decoder_forward(theirs, _jcfg(cfg), jnp.asarray(tokens), jenc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("prompt_len,max_len", [(1, 16), (4, 20)])
def test_greedy_decode_matches_jax(pair, prompt_len, max_len):
    """Identical tokens and lengths, with a one-token and a four-token
    forced prompt (the prompt kept, EOS after a finished row)."""
    cfg, ours, theirs, _ = pair
    mel = _mel(cfg, batch=3)
    prompt = np.asarray([[cfg.decoder_start_token_id] + [558 + i, 600, 601][:prompt_len - 1]
                         for i in range(3)], dtype=np.int32)
    enc = whisper.encode(ours, cfg, torch.from_numpy(mel))
    tokens, lengths = whisper.greedy_decode(ours, cfg, enc, torch.from_numpy(prompt), max_len)
    jenc = jwhisper.encode(theirs, _jcfg(cfg), jnp.asarray(mel))
    jt, jl = jax.jit(jwhisper.greedy_decode, static_argnums=(1, 4))(
        theirs, _jcfg(cfg), jenc, jnp.asarray(prompt), max_len)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tokens.numpy()[:, :prompt_len], prompt)


def test_tokenizer_matches_transformers():
    """Language map, task ids and ``decode(ids, skip_special_tokens=True)``
    of 200 seeded random id sequences (a seventh led by
    ``<|startofprev|>``) equal ``WhisperTokenizer``'s; the fast tokenizer
    agrees too once its clean-up of spaces (which the Python tokenizer
    does not do) is off."""
    from transformers import WhisperTokenizer, WhisperTokenizerFast

    ours = asr.WhisperTokenizer(FIXTURE)
    slow = WhisperTokenizer.from_pretrained(FIXTURE)
    fast = WhisperTokenizerFast.from_pretrained(FIXTURE)
    assert len(ours) == len(slow) == len(fast) == 620
    want = {}
    for code in slow.additional_special_tokens:
        if code.startswith("<|") and code.endswith("|>") and len(code) <= 8 and \
                code[2:-2].isalpha():
            want[code[2:-2]] = slow.convert_tokens_to_ids(code)
    assert ours.language_token_ids() == want and len(want) == 5
    for t in ("<|transcribe|>", "<|notimestamps|>", "<|startoftranscript|>", "<|0.02|>",
              "not-a-token"):
        assert ours.convert_tokens_to_ids(t) == slow.convert_tokens_to_ids(t), t
    assert ours.unk_token_id == slow.unk_token_id
    assert ours.all_special_ids == set(slow.all_special_ids)
    rng = np.random.default_rng(0)
    prev = ours.convert_tokens_to_ids("<|startofprev|>")
    for k in range(200):
        ids = rng.integers(0, len(ours), rng.integers(0, 50)).tolist()
        if k % 7 == 0:
            ids = [prev] + ids
        for skip in (True, False):
            got = ours.decode(ids, skip_special_tokens=skip)
            assert got == slow.decode(ids, skip_special_tokens=skip), (ids, skip)
            assert got == fast.decode(ids, skip_special_tokens=skip,
                                      clean_up_tokenization_spaces=False), (ids, skip)

def test_bf16_greedy_decode_widens_once(pair):
    """With bf16 weights (fp32 activations from the first cross-attention
    on, each weight widened): two decodes through one ``Widen`` give the
    tokens a decode with its own ``Widen`` gives, and the second call
    widens nothing new. JAX's decode cannot be the reference here: with
    bf16 weights its scan's carry comes back fp32 and it raises
    ``TypeError`` (ROADMAP.md section 3)."""
    cfg, ours, theirs, _ = pair
    ours = jax.tree.map(lambda t: t.to(torch.bfloat16), ours,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    theirs = jax.tree.map(lambda t: t.astype(jnp.bfloat16), theirs)
    mel = _mel(cfg, batch=3)
    prompt = np.asarray([[cfg.decoder_start_token_id, 558 + i] for i in range(3)], np.int32)
    enc = whisper.encode(ours, cfg, torch.from_numpy(mel))
    want = whisper.greedy_decode(ours, cfg, enc, torch.from_numpy(prompt), 16)
    widen = whisper.Widen()
    sizes = []
    for _ in range(2):
        got = whisper.greedy_decode(ours, cfg, enc, torch.from_numpy(prompt), 16, widen)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        sizes.append(len(widen._made))
    assert sizes[0] == sizes[1] > 0
    assert (want[1] > 2).all()  # each row decoded past its prompt
    jenc = jwhisper.encode(theirs, _jcfg(cfg), jnp.asarray(mel))
    with pytest.raises(TypeError, match="carry"):
        jwhisper.greedy_decode(theirs, _jcfg(cfg), jenc, jnp.asarray(prompt), 16)


def test_load_transcriber_matches_jax(pair):
    """``load_transcriber`` on the HF dir (fp32) against JAX's (with
    ``transformers.WhisperTokenizer``): the same transcripts of three
    clips in two languages and an unknown one, through the forced prompt
    ``<|startoftranscript|><|lang|><|transcribe|><|notimestamps|>``; the
    counters count every call as completed."""
    cfg, _, _, d = pair
    fn = asr.load_transcriber(d, dtype=torch.float32, device="cpu", max_len=24)
    jfn = jasr.load_transcriber(d, dtype=jnp.float32, max_len=24)
    rng = np.random.default_rng(3)
    for lang, n in (("en", 4000), ("de", 9000), ("xx", 7680)):
        wav = (rng.standard_normal(n) * 0.1).astype(np.float32)
        assert fn(wav, lang) == jfn(wav, lang), lang
    assert (fn.calls, fn.completed) == (3, 3)
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)["vocab_size"] == cfg.vocab_size


def test_init_params_shapes():
    cfg = whisper.tiny_whisper_config()
    params = whisper.init_params(cfg, seed=0, device="cpu")
    enc = whisper.encode(params, cfg, torch.zeros(1, 2 * cfg.max_source_positions, cfg.n_mels))
    assert enc.shape == (1, cfg.max_source_positions, cfg.d_model)
    logits = whisper.decoder_forward(params, cfg, torch.zeros(1, 4, dtype=torch.long), enc)
    assert logits.shape == (1, 4, cfg.vocab_size)
