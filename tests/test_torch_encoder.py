"""The port's codec encoder against the JAX package's, fp32, on the same
numpy inputs and converted weights: FSQ encode, the tiny acoustic and
semantic encoders and ``encode_features`` (codes identical), and the
full-graph golden fixture (``tests/fixtures/codec_golden.npz``, a
torch-built weight-normed state dict) through the port's own
``torch_import``, encoder and decoder side, as ``tests/test_codec_golden.py``
holds the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models.codec import encoder as je
from tts_max_tpu.models.codec import fsq as jfsq
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models.codec import encoder as te
from tts_max_tpu_torch.models.codec import fsq as tfsq
from tts_max_tpu_torch.models.codec import torch_import, vocos

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "codec_golden.npz")


@pytest.fixture(scope="module")
def tiny():
    """Weights drawn by the port (JAX's init compiles for ~25 s on the CPU)
    with random SnakeBeta parameters and conv kernels x10, so that signals
    survive the tiny stack and the codes vary; numpy to both packages."""
    jcfg, tcfg = je.tiny_encoder_config(), te.tiny_encoder_config()
    rng = np.random.default_rng(0)

    def livelier(path, x):
        x = x.numpy()
        if path[-1].key in ("alpha", "beta"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        return x * 10 if path[-1].key == "kernel" and x.ndim == 3 else x

    tree = jax.tree_util.tree_map_with_path(livelier, te.init_encoder(tcfg, 0, device="cpu"))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.encoder_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((2, 3200)) * 0.3).astype(np.float32)
    feats = rng.standard_normal((2, 10, jcfg.semantic_input_dim)).astype(np.float32)
    return jcfg, tcfg, params, tparams, wav, feats


def test_fsq_encode_matches_jax():
    jcfg, tcfg = jfsq.FSQConfig(dim=32), tfsq.FSQConfig(dim=32)
    params = jfsq.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    x = (np.random.default_rng(2).standard_normal((3, 50, 32)) * 3).astype(np.float32)
    z_ref = x @ np.asarray(params["project_in"]["kernel"])
    z = (torch.from_numpy(x) @ tparams["project_in"]["kernel"]).numpy()
    np.testing.assert_allclose(z, z_ref, atol=1e-5)
    out_ref, idx_ref = jfsq.encode(params, jnp.asarray(x), jcfg)
    out, idx = tfsq.encode(tparams, torch.from_numpy(x), tcfg)
    assert idx.dtype == torch.int32 and len(np.unique(np.asarray(idx_ref))) > 50
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=1e-5)
    # both round half to even
    halves = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(halves))))


@pytest.mark.parametrize("part", ["acoustic", "semantic", "codes"])
def test_tiny_encoder_matches_jax(tiny, part):
    jcfg, tcfg, params, tparams, wav, feats = tiny
    if part == "acoustic":
        ref = np.asarray(je.acoustic_encoder(jnp.asarray(wav), params["acoustic"], jcfg))
        got = te.acoustic_encoder(torch.from_numpy(wav), tparams["acoustic"], tcfg).numpy()
        assert got.shape == ref.shape == (2, 10, tcfg.acoustic_dim)
        # the x10 kernels grow the signal ~1e5-fold: hold it relative to its scale
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    elif part == "semantic":
        ref = np.asarray(je.semantic_encoder(jnp.asarray(feats), params["semantic"], jcfg))
        got = te.semantic_encoder(torch.from_numpy(feats), tparams["semantic"], tcfg).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        ref = np.asarray(je.encode_features(params, jnp.asarray(wav), jnp.asarray(feats), jcfg))
        got = te.encode_features(tparams, torch.from_numpy(wav), torch.from_numpy(feats),
                                 tcfg).numpy()
        assert len(np.unique(ref)) > 5
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("length", [3199, 3200, 17])
def test_pad_wav_for_encode_matches_jax(length):
    wav = np.ones((2, length), np.float32)
    np.testing.assert_array_equal(te.pad_wav_for_encode(wav), je.pad_wav_for_encode(wav))


def test_encoder_from_numpy_checks_the_config(tiny):
    _, tcfg, params, _, _, _ = tiny
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="semantic initial kernel"):
        convert.encoder_from_numpy(tree, te.EncoderConfig(**{**tcfg.__dict__,
                                                             "semantic_dim": 8}), "cpu")


# --- the golden fixture through the port's torch_import ---------------------------


@pytest.fixture(scope="module")
def golden():
    data = dict(np.load(FIXTURE))
    return data, {k: v for k, v in data.items() if not k.startswith("__")}


GOLDEN_ENC = te.EncoderConfig(num_generator_features=4, up_ratios=(2, 2, 4, 4, 5),
                              acoustic_dim=32, semantic_input_dim=8, semantic_dim=32,
                              fsq=tfsq.FSQConfig(dim=64))


def test_full_encoder_graph_matches_golden(golden):
    data, sd = golden
    params = torch_import.import_encoder(sd, GOLDEN_ENC, device="cpu")
    wav, feats = torch.from_numpy(data["__wav"]), torch.from_numpy(data["__feats"])
    ac = te.acoustic_encoder(wav, params["acoustic"], GOLDEN_ENC)
    np.testing.assert_allclose(ac.numpy(), data["__enc_acoustic"], atol=2e-4, rtol=2e-4)
    se = te.semantic_encoder(feats, params["semantic"], GOLDEN_ENC)
    np.testing.assert_allclose(se.numpy(), data["__enc_semantic"], atol=2e-4, rtol=2e-4)
    fused = vocos.linear(torch.cat([se, ac], dim=-1), params["fusion"])
    np.testing.assert_allclose(fused.numpy(), data["__enc_fused"], atol=2e-4, rtol=2e-4)
    codes = te.encode_features(params, wav, feats, GOLDEN_ENC)
    np.testing.assert_array_equal(codes.numpy(), data["__enc_codes"])


def test_full_decoder_graph_matches_golden(golden):
    data, sd = golden
    cfg = vocos.tiny_vocos_config()
    params = torch_import.import_decoder(sd, cfg, device="cpu")
    codes = torch.from_numpy(data["__dec_codes"])
    emb = tfsq.decode_indices(params["quantizer"], codes, cfg.fsq)
    np.testing.assert_allclose(emb.numpy(), data["__dec_emb"], atol=1e-5, rtol=1e-5)
    bb = vocos.backbone(vocos.linear(emb, params["fc_post_a"]), params["backbone"], cfg)
    np.testing.assert_allclose(bb.numpy(), data["__dec_backbone"], atol=5e-4, rtol=5e-4)
    wav = vocos.decode(params, codes, cfg).numpy()
    ref = data["__dec_wav"]
    assert wav.shape == ref.shape
    np.testing.assert_allclose(wav, ref, atol=5e-4, rtol=1e-3)
    assert np.linalg.norm(wav - ref) / np.linalg.norm(ref) < 1e-3


def test_create_encoder_from_a_checkpoint(golden, tmp_path):
    """``create_encoder`` reads a torch file of the golden state dict as the
    same weights as ``params=``; the w2v-bert stand-in hands back the
    fixture's semantic features."""
    from tts_max_tpu_torch.models.codec import api

    data, sd = golden
    path = tmp_path / "codec.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)

    def semantic_fn(wav):
        assert wav.shape == (2, 3200 + 320)  # padded by a whole hop on the host
        return torch.from_numpy(data["__feats"])

    kw = dict(cfg=GOLDEN_ENC, semantic_fn=semantic_fn, device="cpu")
    from_file = api.create_encoder(checkpoint_path=str(path), **kw).encode(data["__wav"])
    params = torch_import.import_encoder(sd, GOLDEN_ENC, device="cpu")
    from_params = api.create_encoder(params=params, **kw).encode(data["__wav"])
    assert from_file.shape == (2, 10) and from_file.dtype == np.int32
    np.testing.assert_array_equal(from_file, from_params)
    np.testing.assert_array_equal(from_file, data["__enc_codes"])
