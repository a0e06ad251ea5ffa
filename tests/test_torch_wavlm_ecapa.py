"""The port's WavLM (``tts_max_tpu_torch/models/wavlm.py``) and ECAPA-TDNN
(``training/rlhf/ecapa.py``) against the JAX package's on the CPU, in fp32:
a tiny seeded ``transformers`` WavLM read by both importers (the trees
equal, the port's exporter giving the state dict back), the feature
encoder, the relative position bias, the hidden-state stack and the
length masking within 1e-4; ECAPA's fbank features, embedding and
``import_torch_state_dict`` of a UniSpeech-named checkpoint against JAX's
within 1e-4; the WavLM + ECAPA similarity embedder, loaded from an HF dir
and a checkpoint with ``feature_weight``, against JAX's within 1e-4, with
its call counters."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.models import wavlm as jwavlm
from tts_max_tpu.training.rlhf import ecapa as jecapa
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import wavlm
from tts_max_tpu_torch.training.rlhf import ecapa

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_config(cfg):
    from transformers import WavLMConfig as HFWavLMConfig

    return HFWavLMConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.ffn_dim,
        conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernels),
        conv_stride=list(cfg.conv_strides), num_buckets=cfg.num_buckets,
        max_bucket_distance=cfg.max_distance, num_conv_pos_embeddings=cfg.pos_conv_kernel,
        num_conv_pos_embedding_groups=cfg.pos_conv_groups, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=True, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, activation_dropout=0.0,
        layerdrop=0.0, apply_spec_augment=False)


def _jcfg(cfg):
    return jwavlm.WavLMConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def pair():
    """(cfg, port params, JAX params, HF state dict) of a seeded tiny WavLM
    with its gate constants, biases and norms moved off their init."""
    from transformers import WavLMModel

    cfg = wavlm.tiny_wavlm_config()
    torch.manual_seed(0)
    model = WavLMModel(_hf_config(cfg)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "layer_norm" in name or "rel_pos_const" in name:
                p.add_(torch.randn_like(p) * 0.1)
    sd = model.state_dict()
    return cfg, wavlm.import_hf_state_dict(sd, cfg, device="cpu"), \
        jwavlm.import_hf_state_dict(sd, _jcfg(cfg)), sd


def _wav(batch=2, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) * 0.1).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_importer_and_exporter(pair):
    """Both importers give equal trees; ``convert.wavlm_from_numpy`` carries
    JAX's tree over unchanged; the exporter's state dict re-imports to the
    same tree (the weight-normed conv within fp32 rounding)."""
    cfg, ours, theirs, _ = pair
    carried = convert.wavlm_from_numpy(jax.tree.map(np.asarray, theirs), cfg, device="cpu")
    back = wavlm.import_hf_state_dict(wavlm.export_hf_state_dict(ours, cfg), cfg, device="cpu")
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        a, b, c = ours, carried, back
        for k in keys:
            a, b, c = a[k], b[k], c[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf), err_msg=str(keys))
        np.testing.assert_array_equal(b.numpy(), np.asarray(leaf), err_msg=str(keys))
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=str(keys))
        n += 1
    assert n > 20


def test_feature_encoder_and_position_bias(pair):
    cfg, ours, theirs, _ = pair
    wav = _wav()
    _close(wavlm.feature_encoder(ours, cfg, torch.from_numpy(wav)),
           jwavlm.feature_encoder(theirs, _jcfg(cfg), jnp.asarray(wav)))
    for t in (7, 40, 133):
        np.testing.assert_array_equal(wavlm.relative_position_buckets(cfg, t),
                                      jwavlm.relative_position_buckets(_jcfg(cfg), t))
        _close(wavlm.compute_position_bias(ours, cfg, t),
               jwavlm.compute_position_bias(theirs, _jcfg(cfg), t))
    assert wavlm.frame_count(cfg, 2000) == jwavlm.frame_count(_jcfg(cfg), 2000)


def test_hidden_stack_and_masking(pair):
    """The [L+1, B, T, D] stack, unmasked and with lengths (one row padded)."""
    cfg, ours, theirs, _ = pair
    wav = _wav(n=2400, seed=3)
    got = wavlm.encode(ours, cfg, torch.from_numpy(wav))
    want = jwavlm.encode(theirs, _jcfg(cfg), jnp.asarray(wav))
    assert tuple(got.shape) == want.shape == (cfg.num_layers + 1, 2, 119, cfg.hidden_size)
    _close(got, want)
    lengths = np.asarray([2400, 1500], np.int32)
    got = wavlm.encode(ours, cfg, torch.from_numpy(wav), lengths=torch.from_numpy(lengths))
    want = jwavlm.encode(theirs, _jcfg(cfg), jnp.asarray(wav), lengths=jnp.asarray(lengths))
    _close(got, want)
    np.testing.assert_array_equal(
        wavlm.frame_count_dynamic(cfg, torch.from_numpy(lengths)).numpy(),
        np.asarray(jax.vmap(lambda n: jwavlm.frame_count_dynamic(_jcfg(cfg), n))(
            jnp.asarray(lengths))))


def _ecfg(feat_dim):
    return ecapa.ECAPAConfig(feat_dim=feat_dim, channels=32, emb_dim=8, scale=4,
                             se_bottleneck_dim=8, attention_channels=8, cat_channels=96)


def _jecfg(cfg):
    return jecapa.ECAPAConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _liven(params, seed):
    """Seeded non-trivial BatchNorm statistics and biases (init has
    identity BatchNorms and zero biases)."""
    gen = torch.Generator().manual_seed(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, key) for v in t]
        r = torch.rand(t.shape, generator=gen)
        if key in ("scale", "var"):
            return 0.5 + r
        if key in ("bias", "mean"):
            return r - 0.5
        return t

    return walk(params)


@pytest.fixture(scope="module")
def ecapa_pair():
    cfg = _ecfg(16)
    ours = _liven(ecapa.init_params(cfg, seed=1, device="cpu"), 2)
    theirs = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ours,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    return cfg, ours, theirs


def test_ecapa_embedding_matches_jax(ecapa_pair):
    cfg, ours, theirs = ecapa_pair
    wav = _wav(n=6000, seed=4)
    feats = ecapa.fbank_features(torch.from_numpy(wav), n_mels=cfg.feat_dim)
    jfeats = jecapa.fbank_features(jnp.asarray(wav), n_mels=cfg.feat_dim)
    _close(feats, jfeats)
    _close(ecapa.embed_features(ours, feats, cfg),
           jecapa.embed_features(theirs, jfeats, _jecfg(cfg)))
    fn = ecapa.make_embed_fn(ours, cfg, device="cpu")
    jfn = jecapa.make_embed_fn(theirs, _jecfg(cfg))
    np.testing.assert_allclose(fn(wav[0]), jfn(wav[0]), atol=TOL, rtol=TOL)
    assert (fn.calls, fn.completed) == (1, 1)


def test_ecapa_checkpoint_import_matches_jax(ecapa_pair):
    """A UniSpeech-named state dict (the port's exporter) through both
    importers gives equal trees, and the JAX tree carried over by
    ``convert.ecapa_from_numpy``."""
    cfg, ours, _ = ecapa_pair
    sd = ecapa.export_torch_state_dict(ours, cfg)
    got = ecapa.import_torch_state_dict(sd, cfg, device="cpu")
    want = jecapa.import_torch_state_dict(sd, _jecfg(cfg))
    carried = convert.ecapa_from_numpy(want, cfg, device="cpu")
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        a, b, c = got, ours, carried
        for k in keys:
            a, b, c = a[k], b[k], c[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf), err_msg=str(keys))
        np.testing.assert_array_equal(b.numpy(), np.asarray(leaf), err_msg=str(keys))
        np.testing.assert_array_equal(c.numpy(), np.asarray(leaf), err_msg=str(keys))
        n += 1
    assert n == len(sd) > 50


def test_similarity_embedder_from_files_matches_jax(pair, tmp_path):
    """``load_wavlm_similarity_embedder`` on an HF dir (the port's writer)
    and a UniSpeech checkpoint with ``feature_weight`` (``module.``
    prefixed, under "model"), against JAX's loader on the same files."""
    cfg, ours, _, _ = pair
    wavlm.save_hf_dir(ours, cfg, str(tmp_path / "wavlm"))
    ecfg = ecapa.ECAPAConfig(feat_dim=cfg.hidden_size)
    sd = ecapa.export_torch_state_dict(_liven(ecapa.init_params(ecfg, seed=5, device="cpu"), 6),
                                       ecfg)
    sd["feature_weight"] = torch.linspace(-1, 1, cfg.num_layers + 1)
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / "ecapa.pt")
    fn = ecapa.load_wavlm_similarity_embedder(str(tmp_path / "wavlm"),
                                              str(tmp_path / "ecapa.pt"), device="cpu")
    jfn = jecapa.load_wavlm_similarity_embedder(str(tmp_path / "wavlm"),
                                                str(tmp_path / "ecapa.pt"))
    for seed in (7, 8):
        wav = _wav(batch=1, n=3200, seed=seed)[0]
        np.testing.assert_allclose(fn(wav), jfn(wav), atol=TOL, rtol=TOL)
    assert (fn.calls, fn.completed) == (2, 2)
    assert os.path.isfile(tmp_path / "wavlm" / "config.json")
