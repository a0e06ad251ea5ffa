"""The port's codec decoder against the JAX package's on the same converted
weights: FSQ index decode, the same-padding ISTFT and the whole Vocos
decode (the 16 kHz layout and one with an upsampler), fp32, atol 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.models.codec import fsq as jfsq
from tts_max_tpu.models.codec import vocos as jv
from tts_max_tpu.ops import stft as jstft
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models.codec import api
from tts_max_tpu_torch.models.codec import fsq as tfsq
from tts_max_tpu_torch.models.codec import torch_import
from tts_max_tpu_torch.models.codec import vocos as tv
from tts_max_tpu_torch.ops import stft as tstft


def _codes(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 65536, (b, t)).astype(np.int32)


def test_decode_indices_matches_jax():
    cfg = jfsq.FSQConfig(dim=32)
    params = jfsq.init_params(jax.random.PRNGKey(0), cfg)
    idx = _codes(2, 9)
    idx[0, :3] = [0, 65535, 12345]
    ref = jfsq.decode_indices(params, jnp.asarray(idx), cfg)
    tparams = {"project_out": {k: torch.from_numpy(np.asarray(v))
                               for k, v in params["project_out"].items()}}
    ours = tfsq.decode_indices(tparams, torch.from_numpy(idx), tfsq.FSQConfig(dim=32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(
        tfsq.indices_to_codes(torch.from_numpy(idx), tfsq.FSQConfig()).numpy(),
        np.asarray(jfsq.indices_to_codes(jnp.asarray(idx), jfsq.FSQConfig())))


@pytest.mark.parametrize("n_fft,hop,t", [(1280, 320, 7), (64, 16, 12)])
def test_istft_same_matches_jax(n_fft, hop, t):
    rng = np.random.default_rng(1)
    spec = (rng.standard_normal((2, n_fft // 2 + 1, t))
            + 1j * rng.standard_normal((2, n_fft // 2 + 1, t))).astype(np.complex64)
    ref = np.asarray(jstft.istft_same(jnp.asarray(spec), n_fft, hop))
    ours = tstft.istft_same(torch.from_numpy(spec), n_fft, hop).numpy()
    assert ours.shape == ref.shape == (2, t * hop)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _tiny_upsampling():
    cfg = jv.tiny_vocos_config()
    return (jv.VocosConfig(**{**cfg.__dict__, "upsample_factors": (3, 2),
                              "upsample_kernel_sizes": (7, 4)}),
            tv.VocosConfig(**{**tv.tiny_vocos_config().__dict__,
                              "upsample_factors": (3, 2),
                              "upsample_kernel_sizes": (7, 4)}))


@pytest.mark.parametrize("upsample", [False, True])
def test_vocos_decode_matches_jax(upsample):
    jcfg, tcfg = (_tiny_upsampling() if upsample
                  else (jv.tiny_vocos_config(), tv.tiny_vocos_config()))
    params = jv.init_decoder(jax.random.PRNGKey(2), jcfg)
    # non-zero biases and norm offsets, so that the test sees them
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if path[-1].key == "bias" else x, params)
    codes = _codes(1, 23, seed=3)
    ref = np.asarray(jax.jit(jv.decode, static_argnums=2)(params, jnp.asarray(codes), jcfg))
    tparams = convert.vocos_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                       tcfg, device="cpu")
    ours = tv.decode(tparams, torch.from_numpy(codes), tcfg).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_audio_decoder_wraps_decode():
    cfg = tv.tiny_vocos_config()
    params = tv.init_decoder(cfg, seed=0, device="cpu")
    dec = api.AudioDecoder(params, cfg, api.DecoderConfig(), device="cpu")
    codes = _codes(1, 5)[0]
    wav = dec.decode(codes)
    assert wav.shape == (1, 5 * 320) and wav.dtype == np.float32
    np.testing.assert_allclose(
        wav, tv.decode(params, torch.from_numpy(codes)[None], cfg).numpy())


def test_create_decoder_needs_params(tmp_path, monkeypatch):
    """``create_decoder`` needs ``params=`` or a checkpoint: a torch file of
    the golden fixture's decoder state dict, its convs rewritten in both
    weight-norm forms, decodes as the same weights given as ``params=``
    (and as the fixture's torch decoder). The fixture has the tiny widths,
    which stand in for the published ones the config gives."""
    with pytest.raises(ValueError, match="checkpoint_path or params"):
        api.create_decoder(config=api.DecoderConfig(), device="cpu")
    data = dict(np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                     "codec_golden.npz")))
    sd = {k: torch.from_numpy(v) for k, v in data.items()
          if k.startswith(("generator.", "fc_post_a."))}
    rng = np.random.default_rng(0)
    convs = sorted(k[:-len(".weight")] for k, v in sd.items()
                   if k.endswith(".weight") and v.ndim == 3)
    assert len(convs) == 9
    for i, base in enumerate(convs):
        w = sd.pop(f"{base}.weight")
        v = w * torch.from_numpy(rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)).astype(np.float32))
        g = w.norm(dim=(1, 2), keepdim=True)
        names = (("weight_g", "weight_v") if i % 2 else
                 ("parametrizations.weight.original0", "parametrizations.weight.original1"))
        sd[f"{base}.{names[0]}"], sd[f"{base}.{names[1]}"] = g, v
    path = tmp_path / "codec.pt"
    torch.save({"state_dict": sd}, path)
    cfg = tv.tiny_vocos_config()
    monkeypatch.setattr(api.DecoderConfig, "vocos_config", lambda self: cfg)
    dec = api.create_decoder(checkpoint_path=str(path), device="cpu")
    assert dec.sample_rate == 16000 and dec.token_rate == 50
    golden = {k: v for k, v in data.items() if not k.startswith("__")}
    ref = api.create_decoder(params=torch_import.import_decoder(golden, cfg, device="cpu"),
                             device="cpu")
    codes = data["__dec_codes"]
    wav = dec.decode(codes)
    np.testing.assert_allclose(wav, ref.decode(codes), atol=1e-5)
    np.testing.assert_allclose(wav, data["__dec_wav"], atol=5e-4, rtol=1e-3)
