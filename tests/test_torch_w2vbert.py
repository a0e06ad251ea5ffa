"""The port's wav2vec-BERT against the JAX package's on the same weights,
fp32: the conformer layer loop at 0..n layers, the HF state-dict import, the
semantic function, and the port's own feature extractor against
transformers' ``SeamlessM4TFeatureExtractor`` (the test may import
transformers; the port does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.models.codec import w2vbert as jw
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models.codec import w2vbert as tw


@pytest.fixture(scope="module")
def tiny():
    """Weights drawn by the port (JAX's init compiles for seconds on the
    CPU), with non-zero biases and norm offsets so that the test sees them;
    numpy to both packages."""
    jcfg, tcfg = jw.tiny_w2vbert_config(), tw.tiny_w2vbert_config()
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: x.numpy() + 0.05 if path[-1].key == "bias" else x.numpy(),
        tw.init_params(tcfg, seed=0, device="cpu"))
    return jcfg, tcfg, _to_jax(tree), convert.w2vbert_from_numpy(tree, tcfg, device="cpu")


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("n_layers", [0, 1, 2, 3])
def test_encode_matches_jax(tiny, n_layers):
    jcfg, tcfg, params, tparams = tiny
    feats = np.random.default_rng(0).standard_normal((2, 23, tcfg.feature_dim)).astype(np.float32)
    ref = np.asarray(jw.encode(params, jnp.asarray(feats), jcfg, num_layers=n_layers))
    got = tw.encode(tparams, torch.from_numpy(feats), tcfg, num_layers=n_layers).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)
    if n_layers == tcfg.num_layers_to_run:
        np.testing.assert_array_equal(tw.encode(tparams, torch.from_numpy(feats), tcfg)
                                      .numpy(), got)


def test_import_hf_state_dict_matches_jax_import():
    transformers = pytest.importorskip("transformers")
    cfg = tw.tiny_w2vbert_config()
    hf_cfg = transformers.Wav2Vec2BertConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
        feature_projection_input_dim=cfg.feature_dim, position_embeddings_type="relative_key",
        left_max_position_embeddings=cfg.left_max_pos,
        right_max_position_embeddings=cfg.right_max_pos,
        conv_depthwise_kernel_size=cfg.conv_kernel, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, conformer_conv_dropout=0.0,
        layerdrop=0.0)
    torch.manual_seed(0)
    model = transformers.Wav2Vec2BertModel(hf_cfg).eval()
    sd = model.state_dict()
    ours = tw.import_hf_state_dict(sd, cfg)
    ref = jw.import_hf_state_dict(sd, jw.tiny_w2vbert_config())
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    params = convert.w2vbert_from_numpy(ours, cfg, device="cpu")
    feats = np.random.default_rng(1).standard_normal((1, 12, cfg.feature_dim)).astype(np.float32)
    with torch.no_grad():
        hidden = model(input_features=torch.from_numpy(feats), output_hidden_states=True)
    np.testing.assert_allclose(tw.encode(params, torch.from_numpy(feats), cfg).numpy(),
                               hidden.hidden_states[cfg.num_layers_to_run].numpy(), atol=2e-4)


@pytest.mark.parametrize("length", [3200, 3360, 8160])
def test_extract_features_matches_transformers(length):
    """3200 and 8160 samples give 18 and 49 frames: an even count and an
    odd one (padded to even with a zero frame); 3360 another odd one."""
    transformers = pytest.importorskip("transformers")
    wav = (np.random.default_rng(length).standard_normal((2, length)) * 0.1).astype(np.float32)
    ref = transformers.SeamlessM4TFeatureExtractor()(
        list(wav), sampling_rate=16000, return_tensors="np")["input_features"]
    got = tw.extract_features(wav)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_semantic_fn_matches_jax(tiny):
    """The half-hop zero pad, the features and the layers, with a
    feature_dim of 160 as the real features have."""
    pytest.importorskip("transformers")  # the JAX package's features need it
    jcfg = jw.W2VBertConfig(**{**jw.tiny_w2vbert_config().__dict__, "feature_dim": 160})
    tcfg = tw.W2VBertConfig(**{**tw.tiny_w2vbert_config().__dict__, "feature_dim": 160})
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), tw.init_params(tcfg, 4, device="cpu"))
    params = _to_jax(tree)
    tparams = convert.w2vbert_from_numpy(tree, tcfg, device="cpu")
    wav = (np.random.default_rng(2).standard_normal((1, 4800)) * 0.1).astype(np.float32)
    ref = np.asarray(jw.default_semantic_fn(params=params, cfg=jcfg)(wav))
    got = tw.default_semantic_fn(params=tparams, cfg=tcfg, device="cpu")(wav).numpy()
    assert got.shape == ref.shape == (1, 15, tcfg.hidden_size)
    np.testing.assert_allclose(got, ref, atol=2e-4)
