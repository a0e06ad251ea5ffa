"""Codec GAN training in the port (``models/codec/discriminator.py``,
``losses.py``, ``training/codec/gan.py``, ``codec_data.py``, ``gan_loop.py``)
against the JAX package's modules on the CPU, tiny configs, fp32: the
weights are the port's seeded ``init_decoder``, ``init_mpd`` and
``init_msd`` (the discriminators' scaled by 5, so that every layer's features
carry signal) handed to JAX as numpy, the conv kernels in JAX's HWIO layout
(``convert.mpd_from_numpy`` / ``msd_from_numpy`` give them back bitwise).

Tolerances (fp32 sums, FFTs and convolutions of two libraries): features
and losses 1e-5 relative to their largest magnitude; grads per leaf
max|g - ref| <= 1e-4 max|ref|, the train-step tests' bound; updated params
per leaf atol 1e-5 max(|ref|, 1) at Adam eps 1e-3 on both sides (at optax's
1e-8 the first update is about lr * sign(g), so a grad near zero whose fp32
sum differs in sign between the packages moves its weight by 2 lr)."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.core.config import CodecTrainingConfig as JCodecConfig
from tts_max_tpu.data.loader import DataLoader as JLoader
from tts_max_tpu.models.codec import api as japi, discriminator as jdisc
from tts_max_tpu.models.codec import losses as jlosses, vocos as jvocos
from tts_max_tpu.training.codec import codec_data as jcodec_data, gan as jgan
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core.config import CodecTrainingConfig
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.audio_io import save_wav
from tts_max_tpu_torch.data.loader import DataLoader
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.models.codec import api, discriminator as disc, losses, vocos
from tts_max_tpu_torch.parallel.mesh import Mesh
from tts_max_tpu_torch.training import optim
from tts_max_tpu_torch.training.codec import codec_data, gan, gan_loop

T_CODES = 8
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    """A JAX NHWC feature map as the port's NCHW (2-D logits as they are)."""
    x = np.asarray(x)
    return x.transpose(0, 3, 1, 2) if x.ndim == 4 else x


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    if not torch.is_tensor(tree):
        return {prefix[:-1]: np.asarray(tree)}
    a = tree.detach().numpy()  # the port's conv kernels back to JAX's HWIO
    return {prefix[:-1]: a.transpose(2, 3, 1, 0) if a.ndim == 4 else a}


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), \
        (what, np.abs(got - want).max(), np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    vcfg, jvcfg = vocos.tiny_vocos_config(), jvocos.tiny_vocos_config()
    mpd_cfg, msd_cfg = disc.tiny_mpd_config(), disc.tiny_msd_config()
    jmpd_cfg, jmsd_cfg = jdisc.tiny_mpd_config(), jdisc.tiny_msd_config()
    dp = optim.tree_map(lambda t: t * 5.0, {
        "mpd": disc.init_mpd(mpd_cfg, seed=1, device="cpu"),
        "msd": disc.init_msd(msd_cfg, seed=2, device="cpu")})
    hwio = optim.tree_map(lambda t: t.numpy().transpose(2, 3, 1, 0) if t.ndim == 4
                          else t.numpy(), dp)
    back = {"mpd": convert.mpd_from_numpy(hwio["mpd"], mpd_cfg, device="cpu"),
            "msd": convert.msd_from_numpy(hwio["msd"], msd_cfg, device="cpu")}
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(back),
                                                  optim.tree_leaves(dp)))
    jdp = jax.tree_util.tree_map(jnp.asarray, hwio)
    gp = vocos.init_decoder(vcfg, seed=0, device="cpu")
    jgp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), gp)
    rng = np.random.default_rng(3)
    batch = {"audio_codes": rng.integers(0, 65536, (2, T_CODES)).astype(np.int32),
             "wav": (0.1 * rng.standard_normal((2, T_CODES * 320))).astype(np.float32)}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(vcfg=vcfg, jvcfg=jvcfg, mpd_cfg=mpd_cfg, msd_cfg=msd_cfg, jmpd_cfg=jmpd_cfg,
                jmsd_cfg=jmsd_cfg, dp=dp, jdp=jdp, gp=gp, jgp=jgp, batch=batch, pbatch=pbatch)


def test_discriminator_features_match_jax(setup):
    s = setup
    wav = s["batch"]["wav"][:, :2001]  # a length no period divides: the reflect pad
    for fn, jfn, key, cfg, jcfg in ((disc.mpd, jdisc.mpd, "mpd", s["mpd_cfg"], s["jmpd_cfg"]),
                                    (disc.msd, jdisc.msd, "msd", s["msd_cfg"], s["jmsd_cfg"])):
        got = fn(torch.from_numpy(wav), s["dp"][key], cfg)
        want = jfn(jnp.asarray(wav), s["jdp"][key], jcfg)
        assert len(got) == len(want)
        for gs, ws in zip(got, want):
            assert len(gs) == len(ws)
            for i, (g, w) in enumerate(zip(gs, ws)):
                _close(g.detach().numpy(), _nchw(w), what=f"{key} layer {i}")
    init = disc.init_mpd(s["mpd_cfg"], seed=1, device="cpu")
    assert [p["convs"][0]["kernel"].shape for p in init] == \
        [p["convs"][0]["kernel"].shape for p in s["dp"]["mpd"]]
    again = disc.init_mpd(s["mpd_cfg"], seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(init),
                                                  optim.tree_leaves(again)))


def test_losses_match_jax(setup):
    rng = np.random.default_rng(4)
    # a generated wav at another loudness than the true one (the rms loss is
    # a squared dB difference: fp32 errors in two near-equal dB values would
    # dominate it)
    x, y = (rng.standard_normal((2, 4096)).astype(np.float32) * a for a in (0.2, 0.5))
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)

    def all_losses(lib, a, b):
        return (lib.multi_resolution_mel_loss(a, b), lib.stft_loss(a, b, 512, 128, 240),
                lib.multi_resolution_stft_loss(a, b), lib.rms_loss(a, b), lib.gen_loss(a),
                *lib.disc_loss(a, b))

    want = jax.jit(functools.partial(all_losses, jlosses))(jx, jy)
    for i, (got, w) in enumerate(zip(all_losses(losses, tx, ty), want, strict=True)):
        _close(float(got), float(w), what=f"loss {i}")
    s = setup
    fx = disc.mpd(tx, s["dp"]["mpd"], s["mpd_cfg"]) + disc.msd(tx, s["dp"]["msd"], s["msd_cfg"])
    fy = disc.mpd(ty, s["dp"]["mpd"], s["mpd_cfg"]) + disc.msd(ty, s["dp"]["msd"], s["msd_cfg"])
    jfx = jdisc.mpd(jx, s["jdp"]["mpd"], s["jmpd_cfg"]) + jdisc.msd(jx, s["jdp"]["msd"],
                                                                     s["jmsd_cfg"])
    jfy = jdisc.mpd(jy, s["jdp"]["mpd"], s["jmpd_cfg"]) + jdisc.msd(jy, s["jdp"]["msd"],
                                                                     s["jmsd_cfg"])
    for got, want in ((losses.feature_matching_loss(fx, fy), jlosses.feature_matching_loss(jfx, jfy)),
                      (losses.adversarial_loss(fx), jlosses.adversarial_loss(jfx)),
                      (losses.discriminator_loss(fy, fx), jlosses.discriminator_loss(jfy, jfx))):
        _close(float(got), float(want), what="feature loss")


def _assert_grads(got, want, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), what
    for k in w:
        _close(g[k], w[k], rel=1e-4, what=f"{what} {k}")
        assert np.abs(w[k]).max() > 0, f"{what} {k}: no grad reaches it"


def test_grads_match_jax(setup):
    s = setup
    cfg, jcfg = CodecTrainingConfig(), JCodecConfig()
    jt, jf = jgan.split_generator_params(s["jgp"])
    yt = jnp.asarray(s["batch"]["wav"])
    codes = jnp.asarray(s["batch"]["audio_codes"])
    y_gen = jvocos.decode(jgan.merge_generator_params(jt, jf), codes, s["jvcfg"])

    def jd(dp):
        return (jlosses.discriminator_loss(jdisc.mpd(yt, dp["mpd"], s["jmpd_cfg"]),
                                           jdisc.mpd(y_gen, dp["mpd"], s["jmpd_cfg"]))
                + jlosses.discriminator_loss(jdisc.msd(yt, dp["msd"], s["jmsd_cfg"]),
                                             jdisc.msd(y_gen, dp["msd"], s["jmsd_cfg"])))

    def jg(t):
        y = jvocos.decode(jgan.merge_generator_params(t, jf), codes, s["jvcfg"])
        return jgan.generator_losses(yt, y, s["jdp"]["mpd"], s["jdp"]["msd"], s["jmpd_cfg"],
                                     s["jmsd_cfg"], jcfg)[0]

    pt, pf = gan.split_generator_params(s["gp"])
    gin = optim.tree_map(lambda t: t.detach().requires_grad_(), pt)
    y = vocos.decode(gan.merge_generator_params(gin, pf), s["pbatch"]["audio_codes"], s["vcfg"])
    _close(y.detach().numpy(), np.asarray(y_gen), what="generated wav")
    din = optim.tree_map(lambda t: t.detach().requires_grad_(), s["dp"])
    d_loss = gan._disc_loss(s["pbatch"]["wav"], y.detach(), din, s["mpd_cfg"], s["msd_cfg"])
    jd_loss, jd_grads = jax.jit(jax.value_and_grad(jd))(s["jdp"])
    _close(float(d_loss.detach()), float(jd_loss), what="disc loss")
    _assert_grads(gan._grads(d_loss, din), jd_grads, "disc grad")
    g_loss, _ = gan.generator_losses(s["pbatch"]["wav"], y, s["dp"]["mpd"], s["dp"]["msd"],
                                     s["mpd_cfg"], s["msd_cfg"], cfg)
    jg_loss, jg_grads = jax.jit(jax.value_and_grad(jg))(jt)
    _close(float(g_loss.detach()), float(jg_loss), what="gen loss")
    _assert_grads(gan._grads(g_loss, gin), jg_grads, "gen grad")


@pytest.fixture(scope="module")
def steps(setup):
    """Three GAN steps on each side, Adam eps 1e-3 (see the module doc), the
    discriminator's lr 1e-2 so that its update moves the generator's loss."""
    s = setup
    cfg = CodecTrainingConfig(generator_lr=LR, discriminator_lr=1e-2)
    jcfg = JCodecConfig(generator_lr=LR, discriminator_lr=1e-2)
    jtx = [optax.adamw(lr, b1=0.9, b2=0.95, eps=1e-3, weight_decay=0.1)
           for lr in (LR, 1e-2)]
    ptx = list(gan.create_gan_optimizers(cfg))
    for tx in ptx:
        tx.eps = 1e-3
    jt, jf = jgan.split_generator_params(s["jgp"])
    pt, pf = gan.split_generator_params(s["gp"])
    jstep = jax.jit(functools.partial(
        jgan.gan_train_step, gen_frozen=jf, vocos_cfg=s["jvcfg"], mpd_cfg=s["jmpd_cfg"],
        msd_cfg=s["jmsd_cfg"], cfg=jcfg, gen_tx=jtx[0], disc_tx=jtx[1]))
    pstep = gan.make_gan_step(s["vcfg"], s["mpd_cfg"], s["msd_cfg"], cfg, pf, *ptx)
    jstate = (jt, s["jdp"], jtx[0].init(jt), jtx[1].init(s["jdp"]))
    pstate = (pt, s["dp"], ptx[0].init(pt), ptx[1].init(s["dp"]))
    jbatch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    out = []
    for _ in range(3):
        *jstate, jm = jstep(*jstate, jbatch)
        *pstate, pm = pstep(*pstate, s["pbatch"])
        out.append((jstate, jm, pstate, pm))
    return out


@pytest.mark.parametrize("n", [1, 3])
def test_gan_train_step_matches_jax(steps, setup, n):
    jstate, jm, pstate, pm = steps[n - 1]
    for name in pm._fields:
        _close(float(getattr(pm, name)), float(getattr(jm, name)), rel=1e-5 * n, what=name)
    for what, p, j in (("gen", pstate[0], jstate[0]), ("disc", pstate[1], jstate[1])):
        got, want = _flat(p), _flat(_np(j))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * n * max(np.abs(want[k]).max(), 1),
                                       err_msg=f"{what} {k}")
    assert pstate[2]["count"] == n and "quantizer" not in pstate[0]
    assert torch.equal(setup["gp"]["quantizer"]["project_out"]["kernel"],
                       vocos.init_decoder(setup["vcfg"], seed=0, device="cpu")["quantizer"][
                           "project_out"]["kernel"])  # frozen, untouched


def test_generator_loss_reads_the_updated_discriminator(steps, setup):
    """The step's generator loss is the generator's loss under the
    discriminators *after* their update (as JAX computes it), not before."""
    s = setup
    _, _, pstate, pm = steps[0]
    cfg = CodecTrainingConfig()
    pt, pf = gan.split_generator_params(s["gp"])
    with torch.no_grad():
        y = vocos.decode(gan.merge_generator_params(pt, pf), s["pbatch"]["audio_codes"],
                         s["vcfg"])
    wav = s["pbatch"]["wav"]
    post = gan.generator_losses(wav, y, pstate[1]["mpd"], pstate[1]["msd"], s["mpd_cfg"],
                                s["msd_cfg"], cfg)[0]
    pre = gan.generator_losses(wav, y, s["dp"]["mpd"], s["dp"]["msd"], s["mpd_cfg"],
                               s["msd_cfg"], cfg)[0]
    _close(float(pm.gen_loss), float(post), rel=1e-6, what="post-update")
    assert abs(float(pre) - float(post)) > 1e3 * 1e-6 * abs(float(post))


def test_clip_passes_nonfinite_grads_unscaled():
    grads = {"a": torch.tensor([3.0, 4.0]), "b": [torch.tensor([12.0])]}
    clipped = gan._clip(grads, 1.0)  # norm 13
    assert torch.allclose(clipped["a"], torch.tensor([3.0, 4.0]) / 13)
    assert torch.allclose(clipped["b"][0], torch.tensor([12.0]) / 13)
    small = gan._clip({"a": torch.tensor([0.3, 0.4])}, 1.0)
    assert torch.equal(small["a"], torch.tensor([0.3, 0.4]))
    for bad in (float("nan"), float("inf")):
        g = {"a": torch.tensor([3.0, bad]), "b": [torch.tensor([12.0])]}
        out = gan._clip(g, 1.0)
        assert torch.equal(out["b"][0], torch.tensor([12.0]))  # unscaled, as JAX
        jout = jgan._clip({"a": jnp.asarray([3.0, bad]), "b": [jnp.asarray([12.0])]}, 1.0)
        assert np.array_equal(np.asarray(jout["b"][0]), out["b"][0].numpy())


def test_gan_eval_step_matches_jax(setup):
    s = setup
    jt, jf = jgan.split_generator_params(s["jgp"])
    pt, pf = gan.split_generator_params(s["gp"])
    jm = jax.jit(functools.partial(
        jgan.gan_eval_step, gen_frozen=jf, vocos_cfg=s["jvcfg"], mpd_cfg=s["jmpd_cfg"],
        msd_cfg=s["jmsd_cfg"], cfg=JCodecConfig()))(
            jt, s["jdp"], {k: jnp.asarray(v) for k, v in s["batch"].items()})
    pm = gan.gan_eval_step(pt, s["dp"], s["pbatch"], gen_frozen=pf, vocos_cfg=s["vcfg"],
                           mpd_cfg=s["mpd_cfg"], msd_cfg=s["msd_cfg"], cfg=CodecTrainingConfig())
    for name in pm._fields:
        _close(float(getattr(pm, name)), float(getattr(jm, name)), what=name)
    # a tensor axis: the step of the batch group (which excludes the tensor
    # peers, so they run the same step on the same rows, as in JAX)
    batch_group = object()
    step = gan.make_gan_step(s["vcfg"], s["mpd_cfg"], s["msd_cfg"], CodecTrainingConfig(), pf,
                             None, None, mesh=Mesh((1, 1, 2), groups={"batch": batch_group}))
    assert step.keywords["group"] is batch_group


def _codec_dataset(path, n=6):
    """Codes and wavs of ``n`` samples of 0.3-1.0 s (some shorter than the
    window, one not a hop multiple), written with the port's ``codes_io``."""
    rng = np.random.default_rng(5)
    os.makedirs(path, exist_ok=True)
    samples, lens = [], []
    for i in range(n):
        secs = float(rng.uniform(0.3, 1.0))
        wav = (0.1 * rng.standard_normal(int(16000 * secs) + (7 if i == 2 else 0))
               ).astype(np.float32)
        wav_path = os.path.join(path, f"s{i}.wav")
        save_wav(wav_path, wav, 16000)
        lens.append(len(wav) // 320 + (i % 2))
        samples.append(Sample.from_json({"id": f"s{i}", "wav_path": wav_path,
                                         "transcript": "x", "language": "en",
                                         "duration": secs, "sample_rate": 16000}, "tiny"))
    codes = rng.integers(0, 65536, int(sum(lens))).astype(np.int32)
    codes_io.write_shard(path, "train", codes, np.concatenate([[0], np.cumsum(lens)[:-1]]),
                         samples)


def test_codec_data_windows_equal_jax(tmp_path):
    data = str(tmp_path / "ds")
    _codec_dataset(data)
    pds = codec_data.CodecTrainingDataset(data, "train", 40, seed=7)
    jds = jcodec_data.CodecTrainingDataset(data, "train", 40, seed=7)
    assert len(pds) == len(jds) == 6
    pl = DataLoader(pds, 2, codec_data.codec_collate, seed=7)
    jl = JLoader(jds, 2, jcodec_data.codec_collate, seed=7)
    for epoch in (0, 1):
        for pb, jb in zip(pl.batches(epoch), jl.batches(epoch), strict=True):
            assert pb["wav"].shape == (2, 40 * 320)
            for k in ("audio_codes", "wav", "tokens_processed", "audio_processed_sec"):
                assert pb[k].dtype == jb[k].dtype and np.array_equal(pb[k], jb[k]), k
            assert pb["source"] == jb["source"]


def test_gan_loop_tiny(tmp_path):
    data = str(tmp_path / "ds")
    _codec_dataset(data)
    out = str(tmp_path / "run")
    cfg = {"training": {"seed": 3, "logging_steps": 1, "batch_size": 2},
           "checkpointing": {"save_steps": 2, "keep_only_last_n_checkpoints": 1},
           "codec": {"code_window_size": 16},
           "train_weighted_datasets": {data: 1.0}, "output_dir": out}
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    argv = ["--config_path", path, "--tiny", "--device", "cpu"]
    assert gan_loop.main(argv + ["--dry_run"]) is None
    res = gan_loop.main(argv + ["--total_steps", "3"])
    assert [s for s, _, _ in res.steps] == [1, 2, 3]
    assert all(np.isfinite(list(v.values())).all() for _, v, _ in res.steps)
    _, frozen = gan.split_generator_params(
        vocos.init_decoder(vocos.tiny_vocos_config(), seed=3, device="cpu"))
    assert "quantizer" in res.gen_frozen and "quantizer" not in res.gen_trainable
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(res.gen_frozen),
                                                  optim.tree_leaves(frozen), strict=True))
    assert len(res.checkpoint_seconds) == len(res.save_seconds) == 1
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2"]
    wavs = sorted(os.listdir(os.path.join(out, "quality", "step_2")))
    assert wavs == sorted([f"{k}_{i}.wav" for k in ("generated", "true") for i in range(4)])
    # model_config.json: the JAX package's writer on the same fields, byte for byte
    want = str(tmp_path / "jax_model_config.json")
    japi.DecoderConfig(sample_rate=16000, token_rate=50, hop_length=320).to_json(want)
    with open(os.path.join(out, "model_config.json")) as f, open(want) as g:
        assert f.read() == g.read()
    assert api.DecoderConfig.from_json(os.path.join(out, "model_config.json")) == \
        api.DecoderConfig()
    # the checkpoint restores onto the final params' tree (lists included)
    from tts_max_tpu_torch.training.checkpointing import CheckpointManager

    mgr = CheckpointManager(os.path.join(out, "checkpoints"))
    params, _, stats = mgr.restore(2, {"gen": res.gen_trainable, "disc": res.disc_params},
                                   None, weights_only=True)
    assert stats is None and len(params["disc"]["mpd"]) == 2
