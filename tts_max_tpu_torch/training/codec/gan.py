"""Codec GAN training step (counterpart of ``tts_max_tpu/training/codec/gan.py``):
the Vocos generator against the multi-period and multi-resolution spectral
discriminators, the FSQ quantizer frozen.

One step: the generator's forward once (its graph kept); the
discriminators' LSGAN update on (real, the generated wav detached); then
the generator's update on λ_mel·mel + λ_rms·rms + λ_adv·adv + λ_fm·fm,
read through the discriminators *after* their update, as JAX's step reads
them (its closure sees the reassigned params; its comment says
"pre-update"). Each side's grads are clipped to a global norm of 1 (a
non-finite norm passes the grads unscaled, as JAX's ``_clip`` does) and
stepped by its own ``training/optim.AdamW``. JAX runs the generator's
forward twice, detached and under grad, to the same numbers. There is no
dropout (JAX passes no dropout rng). Losses stay device scalars: a step
reads nothing back to the host.

Over a mesh (``make_gan_step(..., mesh=...)``) the step is data-parallel:
each rank steps on its rows of the global batch, the params stay whole on
every rank, and each side's grads are averaged over the ranks (one
all-reduce of a flat fp32 buffer a side) before its clip, as are the six
losses: every loss is a mean over rows, so with equal rows a rank these
are the global batch's.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from tts_max_tpu_torch.core.config import CodecTrainingConfig
from tts_max_tpu_torch.models.codec import discriminator as disc
from tts_max_tpu_torch.models.codec import losses, vocos
from tts_max_tpu_torch.parallel import collectives
from tts_max_tpu_torch.parallel.mesh import BATCH
from tts_max_tpu_torch.parallel.sharding import map_paths
from tts_max_tpu_torch.training import optim


class GanMetrics(NamedTuple):
    disc_loss: torch.Tensor
    gen_loss: torch.Tensor
    adv_loss: torch.Tensor
    fm_loss: torch.Tensor
    mel_loss: torch.Tensor
    rms_loss: torch.Tensor


def split_generator_params(gen_params: Any) -> tuple[Any, Any]:
    """(trainable, frozen): the FSQ quantizer stays frozen."""
    return ({k: v for k, v in gen_params.items() if k != "quantizer"},
            {"quantizer": gen_params["quantizer"]})


def merge_generator_params(trainable: Any, frozen: Any) -> Any:
    return {**trainable, **frozen}


def generator_losses(y_true, y_gen, mpd_params, msd_params, mpd_cfg, msd_cfg,
                     cfg: CodecTrainingConfig):
    """(total, (mel, rms, adv, fm)); the real wav's features carry no grad."""
    feats_gen_mpd = disc.mpd(y_gen, mpd_params, mpd_cfg)
    feats_gen_msd = disc.msd(y_gen, msd_params, msd_cfg)
    with torch.no_grad():
        feats_true_mpd = disc.mpd(y_true, mpd_params, mpd_cfg)
        feats_true_msd = disc.msd(y_true, msd_params, msd_cfg)
    mel = losses.multi_resolution_mel_loss(y_gen, y_true, cfg.sample_rate)
    rms = losses.rms_loss(y_true, y_gen)
    adv = losses.adversarial_loss(feats_gen_mpd) + losses.adversarial_loss(feats_gen_msd)
    fm = (losses.feature_matching_loss(feats_gen_mpd, feats_true_mpd)
          + losses.feature_matching_loss(feats_gen_msd, feats_true_msd))
    total = (cfg.lambda_mel * mel + cfg.lambda_rms * rms + cfg.lambda_adv * adv
             + cfg.lambda_fm * fm)
    return total, (mel, rms, adv, fm)


def _disc_loss(y_true, y_gen, dp, mpd_cfg, msd_cfg):
    """Both discriminators' LSGAN sums (unweighted)."""
    loss = losses.discriminator_loss(disc.mpd(y_true, dp["mpd"], mpd_cfg),
                                     disc.mpd(y_gen, dp["mpd"], mpd_cfg))
    return loss + losses.discriminator_loss(disc.msd(y_true, dp["msd"], msd_cfg),
                                            disc.msd(y_gen, dp["msd"], msd_cfg))


def _grads(loss, tree):
    """d loss / d each leaf of ``tree`` (whose leaves require grad), as a tree."""
    paths = [p for p, _ in optim.tree_items(tree)]
    g = dict(zip(paths, torch.autograd.grad(loss, [t for _, t in optim.tree_items(tree)])))

    def fill(t, prefix=""):
        if isinstance(t, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [fill(v, f"{prefix}{i}/") for i, v in enumerate(t)]
        return g[prefix[:-1]]

    return fill(tree)


def _mean_over(group, tree):
    """``tree``'s leaves averaged over the group's ranks, through one
    all-reduce of their fp32 concatenation (None: as they are)."""
    if group is None:
        return tree
    items = list(optim.tree_items(tree))
    n = torch.distributed.get_world_size(group)
    summed = dict(zip((p for p, _ in items),
                      collectives.all_reduce_flat([t for _, t in items], group)))
    return map_paths(lambda p, t: (summed[p] / n).to(t.dtype), tree)


def _clip(grads, max_norm):
    """Scale to a global norm of ``max_norm``; a non-finite norm lets the
    grads through unscaled (JAX's rule)."""
    norm = optim.global_norm(grads)
    scale = torch.where(torch.isfinite(norm) & (norm > max_norm), max_norm / norm,
                        torch.ones_like(norm))
    return optim.tree_map(lambda g: g * scale.to(g.dtype), grads)


def gan_train_step(gen_trainable: Any, disc_params: Any, gen_opt_state: Any,
                   disc_opt_state: Any, batch: dict, *, gen_frozen: Any,
                   vocos_cfg: vocos.VocosConfig, mpd_cfg: disc.MPDConfig,
                   msd_cfg: disc.MSDConfig, cfg: CodecTrainingConfig, gen_tx: optim.AdamW,
                   disc_tx: optim.AdamW, grad_clip: float = 1.0, group=None):
    """One GAN macro step. batch: {"audio_codes": [B, Tc], "wav": [B, Ts]}
    tensors on the params' device (with ``group``, this rank's rows).
    Returns the new (gen_trainable, disc_params, gen_opt_state,
    disc_opt_state, GanMetrics)."""
    codes, y_true = batch["audio_codes"], batch["wav"]
    gen_in = optim.tree_map(lambda t: t.detach().requires_grad_(), gen_trainable)
    y_gen = vocos.decode(merge_generator_params(gen_in, gen_frozen), codes, vocos_cfg)

    disc_in = optim.tree_map(lambda t: t.detach().requires_grad_(), disc_params)
    d_loss = cfg.lambda_disc * _disc_loss(y_true, y_gen.detach(), disc_in, mpd_cfg, msd_cfg)
    d_grads = _clip(_mean_over(group, _grads(d_loss, disc_in)), grad_clip)
    d_updates, disc_opt_state = disc_tx.update(d_grads, disc_opt_state, disc_params)
    disc_params = optim.apply_updates(disc_params, d_updates)

    g_loss, (mel, rms, adv, fm) = generator_losses(
        y_true, y_gen, disc_params["mpd"], disc_params["msd"], mpd_cfg, msd_cfg, cfg)
    g_grads = _clip(_mean_over(group, _grads(g_loss, gen_in)), grad_clip)
    g_updates, gen_opt_state = gen_tx.update(g_grads, gen_opt_state, gen_trainable)
    gen_trainable = optim.apply_updates(gen_trainable, g_updates)

    metrics = GanMetrics(*_mean_over(group, [t.detach() for t in (d_loss, g_loss, adv, fm,
                                                                    mel, rms)]))
    return gen_trainable, disc_params, gen_opt_state, disc_opt_state, metrics


@torch.no_grad()
def gan_eval_step(gen_trainable, disc_params, batch, *, gen_frozen, vocos_cfg, mpd_cfg,
                  msd_cfg, cfg) -> GanMetrics:
    """Validation losses, no updates."""
    y_gen = vocos.decode(merge_generator_params(gen_trainable, gen_frozen),
                         batch["audio_codes"], vocos_cfg)
    y_true = batch["wav"]
    d_loss = _disc_loss(y_true, y_gen, disc_params, mpd_cfg, msd_cfg)
    g_loss, (mel, rms, adv, fm) = generator_losses(
        y_true, y_gen, disc_params["mpd"], disc_params["msd"], mpd_cfg, msd_cfg, cfg)
    return GanMetrics(d_loss, g_loss, adv, fm, mel, rms)


def create_gan_optimizers(cfg: CodecTrainingConfig, betas=(0.9, 0.95),
                          weight_decay: float = 0.1) -> tuple[optim.AdamW, optim.AdamW]:
    """The generator's and the discriminators' AdamW (optax.adamw at a
    constant lr: eps 1e-8, decay on every leaf, no mask)."""
    return (optim.AdamW(cfg.generator_lr, betas, weight_decay),
            optim.AdamW(cfg.discriminator_lr, betas, weight_decay))


def make_gan_step(vocos_cfg, mpd_cfg, msd_cfg, cfg, gen_frozen, gen_tx, disc_tx, mesh=None):
    """The step with its static arguments bound; with a ``parallel.mesh.Mesh``
    the data-parallel step over its (data, fsdp) ranks. Under a tensor axis
    the params stay whole, as in JAX: the tensor peers of a rank hold the
    same rows and run the same step (its batch group excludes them)."""
    return functools.partial(gan_train_step, gen_frozen=gen_frozen, vocos_cfg=vocos_cfg,
                             mpd_cfg=mpd_cfg, msd_cfg=msd_cfg, cfg=cfg, gen_tx=gen_tx,
                             disc_tx=disc_tx, group=mesh.group(BATCH) if mesh else None)
