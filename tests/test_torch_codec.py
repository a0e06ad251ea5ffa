"""The port's codec decoder against the JAX package's on the same converted
weights: FSQ index decode, the same-padding ISTFT and the whole Vocos
decode (the 16 kHz layout and one with an upsampler), fp32, atol 1e-4."""

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


def test_create_decoder_needs_params():
    with pytest.raises(NotImplementedError):
        api.create_decoder(config=api.DecoderConfig(), device="cpu")
    params = tv.init_decoder(tv.VocosConfig(depth=1), seed=0, device="cpu")
    dec = api.create_decoder(params=params, config=api.DecoderConfig(), device="cpu")
    assert dec.sample_rate == 16000 and dec.token_rate == 50
