"""Checkpoint importer tests: weight-norm fusion vs torch, key mapping,
and a functional parity check of an imported ResnetBlock vs torch ops."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models.codec import torch_import as ti
from tts_max_tpu.models.codec import vocos


def test_weight_norm_fusion_matches_torch():
    conv = torch.nn.Conv1d(4, 8, 3)
    wn = torch.nn.utils.weight_norm(conv)
    sd = {f"c.{k}": v.detach().numpy() for k, v in wn.state_dict().items()}
    fused = ti.fuse_weight_norm(sd, "c")
    # torch's effective weight after parametrization
    np.testing.assert_allclose(fused, wn.weight.detach().numpy(), atol=1e-6)


def test_weight_norm_fusion_conv_transpose():
    convt = torch.nn.ConvTranspose1d(6, 4, 5)
    wn = torch.nn.utils.weight_norm(convt)
    sd = {f"u.{k}": v.detach().numpy() for k, v in wn.state_dict().items()}
    fused = ti.fuse_weight_norm(sd, "u")
    np.testing.assert_allclose(fused, wn.weight.detach().numpy(), atol=1e-6)


def test_linear_conv_layout():
    lin = torch.nn.Linear(3, 5)
    sd = {f"l.{k}": v.detach().numpy() for k, v in lin.state_dict().items()}
    p = ti.linear_params(sd, "l")
    assert p["kernel"].shape == (3, 5)
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    ref = lin(torch.from_numpy(x)).detach().numpy()
    ours = x @ p["kernel"] + p["bias"]
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_imported_resnet_block_matches_torch():
    """Build the reference ResnetBlock computation in torch, import its
    weights, and check our resnet_block reproduces it."""
    cin = 8
    tb = torch.nn.ModuleDict(
        {
            "norm1": torch.nn.GroupNorm(4, cin, eps=1e-6),
            "conv1": torch.nn.Conv1d(cin, cin, 3, padding=1),
            "norm2": torch.nn.GroupNorm(4, cin, eps=1e-6),
            "conv2": torch.nn.Conv1d(cin, cin, 3, padding=1),
        }
    )
    for m in tb.values():
        for p_ in m.parameters():
            torch.nn.init.normal_(p_, std=0.5)
    x = torch.randn(2, cin, 16)
    with torch.no_grad():
        h = tb["norm1"](x)
        h = h * torch.sigmoid(h)
        h = tb["conv1"](h)
        h = tb["norm2"](h)
        h = h * torch.sigmoid(h)
        h = tb["conv2"](h)
        ref = (x + h).numpy().transpose(0, 2, 1)

    sd = {f"r.{k}": v.detach().numpy() for k, v in tb.state_dict().items()}
    p = ti.resnet_params(sd, "r")
    ours = np.asarray(
        vocos.resnet_block(jnp.asarray(x.numpy().transpose(0, 2, 1)), p, groups=4)
    )
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _fake_decoder_state_dict(depth=2, dim=16, vq_dim=24, n_fft_plus2=1282):
    """Synthesize an xcodec2-shaped decoder state dict with random weights."""
    g = {}
    rng = np.random.default_rng(0)

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    g["generator.quantizer.project_in.weight"] = t(8, vq_dim)
    g["generator.quantizer.project_in.bias"] = t(8)
    g["generator.quantizer.project_out.weight"] = t(vq_dim, 8)
    g["generator.quantizer.project_out.bias"] = t(vq_dim)
    g["fc_post_a.weight"] = t(dim, vq_dim)
    g["fc_post_a.bias"] = t(dim)
    bb = "generator.backbone"
    g[f"{bb}.embed.weight"] = t(dim, dim, 7)
    g[f"{bb}.embed.bias"] = t(dim)
    for pn in ("prior_net", "post_net"):
        for i in range(2):
            b = f"{bb}.{pn}.{i}"
            g[f"{b}.norm1.weight"] = t(dim)
            g[f"{b}.norm1.bias"] = t(dim)
            g[f"{b}.conv1.weight"] = t(dim, dim, 3)
            g[f"{b}.conv1.bias"] = t(dim)
            g[f"{b}.norm2.weight"] = t(dim)
            g[f"{b}.norm2.bias"] = t(dim)
            g[f"{b}.conv2.weight"] = t(dim, dim, 3)
            g[f"{b}.conv2.bias"] = t(dim)
    for i in range(depth):
        b = f"{bb}.transformers.{i}"
        g[f"{b}.att_norm.weight"] = t(dim)
        g[f"{b}.ffn_norm.weight"] = t(dim)
        g[f"{b}.att.c_attn.weight"] = t(3 * dim, dim)
        g[f"{b}.att.c_proj.weight"] = t(dim, dim)
        g[f"{b}.mlp.fc1.weight"] = t(4 * dim, dim)
        g[f"{b}.mlp.fc2.weight"] = t(dim, 4 * dim)
    g[f"{bb}.final_layer_norm.weight"] = t(dim)
    g[f"{bb}.final_layer_norm.bias"] = t(dim)
    g["generator.head.out.weight"] = t(n_fft_plus2, dim)
    g["generator.head.out.bias"] = t(n_fft_plus2)
    return g


def test_import_decoder_structure_and_run():
    from dataclasses import replace
    from tts_max_tpu.models.codec import fsq

    sd = _fake_decoder_state_dict()
    params = ti.import_decoder(sd, depth=2)
    cfg = replace(
        vocos.tiny_vocos_config(),
        hidden_dim=16,
        depth=2,
        heads=2,
        rope_dim=8,
        vq_dim=24,
        fsq=fsq.FSQConfig(dim=24),
        resnet_groups=4,
    )
    # structure: kernel shapes channel-last
    assert params["backbone"]["embed"]["kernel"].shape == (7, 16, 16)
    assert params["backbone"]["blocks"]["att"]["c_attn"]["kernel"].shape == (2, 16, 48)
    assert params["fc_post_a"]["kernel"].shape == (24, 16)
    codes = jnp.zeros((1, 4), dtype=jnp.int32)
    wav = vocos.decode(jax.tree_util.tree_map(jnp.asarray, params), codes, cfg)
    assert wav.shape == (1, 4 * 320)
    assert np.isfinite(np.asarray(wav)).all()


def test_import_encoder_structure():
    """Encoder import with weight-normed convs end-to-end."""
    rng = np.random.default_rng(1)

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def wn_conv(base, cout, cin, k, sd):
        w = t(cout, cin, k)
        sd[f"{base}.weight_g"] = np.linalg.norm(
            w.reshape(cout, -1), axis=1
        ).reshape(cout, 1, 1)
        sd[f"{base}.weight_v"] = w
        sd[f"{base}.bias"] = t(cout)

    def snake(base, c, sd):
        sd[f"{base}.act.alpha"] = t(c)
        sd[f"{base}.act.beta"] = t(c)

    sd = {}
    d0 = 4
    wn_conv("CodecEnc.conv_blocks.0", d0, 1, 7, sd)
    d = d0
    for bi, stride in enumerate((2, 2, 4, 4, 5)):
        d *= 2
        base = f"CodecEnc.conv_blocks.{bi + 1}.block"
        for u in range(3):
            snake(f"{base}.{u}.block.0", d // 2, sd)
            wn_conv(f"{base}.{u}.block.1", d // 2, d // 2, 7, sd)
            snake(f"{base}.{u}.block.2", d // 2, sd)
            wn_conv(f"{base}.{u}.block.3", d // 2, d // 2, 1, sd)
        snake(f"{base}.3", d // 2, sd)
        wn_conv(f"{base}.4", d, d // 2, 2 * stride, sd)
    snake("CodecEnc.conv_final_block.0", d, sd)
    wn_conv("CodecEnc.conv_final_block.1", 16, d, 3, sd)
    sd["SemanticEncoder_module.initial_conv.weight"] = t(16, 8, 3)
    sd["SemanticEncoder_module.residual_blocks.1.weight"] = t(16, 16, 3)
    sd["SemanticEncoder_module.residual_blocks.1.bias"] = t(16)
    sd["SemanticEncoder_module.residual_blocks.3.weight"] = t(16, 16, 3)
    sd["SemanticEncoder_module.residual_blocks.3.bias"] = t(16)
    sd["SemanticEncoder_module.final_conv.weight"] = t(16, 16, 3)
    sd["fc_prior.weight"] = t(32, 32)
    sd["fc_prior.bias"] = t(32)
    sd["generator.quantizer.project_in.weight"] = t(8, 32)
    sd["generator.quantizer.project_in.bias"] = t(8)
    sd["generator.quantizer.project_out.weight"] = t(32, 8)
    sd["generator.quantizer.project_out.bias"] = t(32)

    from tts_max_tpu.models.codec import encoder as enc

    params = jax.tree_util.tree_map(jnp.asarray, ti.import_encoder(sd))
    cfg = enc.tiny_encoder_config()
    wav = jax.random.normal(jax.random.PRNGKey(0), (1, 320 * 3)) * 0.1
    feats = jax.random.normal(jax.random.PRNGKey(1), (1, 3, 8))
    codes = enc.encode_features(params, wav, feats, cfg)
    assert codes.shape == (1, 3)
    assert np.isfinite(np.asarray(codes)).all()
