"""Kernel G's strip walk (``csrc/act1d.cu``) modelled on the CPU, and its
strip-length rule (``ops.act1d.launch_rows``).

The model repeats the kernel's index algebra with torch fp32 operations in
the kernel's order: strips of R output rows per sequence, a warm-up of 5
pairs from 5 preloaded x rows, rings of 6 x rows and 6 pairs indexed by
step mod 6, pairs (E[k+1], O[k]) from x rows k-2 .. k+3, and the edge
strips' clamped rows and replaced pairs. Interior strips, as the kernel
picks them, must read no row outside the sequence and replace no pair. The
model must equal the plain version ``activation1d_fused`` bit for bit,
which is what the kernel is held to on the card."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu_torch.models.codec.encoder import EncoderConfig, pad_wav_for_encode
from tts_max_tpu_torch.ops import act1d
from tts_max_tpu_torch.ops.act1d import act1d_taps, activation1d_fused, snake_beta

ROOT = Path(__file__).resolve().parents[1]
RING = act1d.TRIP


def strip_walk(x: torch.Tensor, p, rows: int) -> torch.Tensor:
    """y = G(x) as the kernel's threads walk it, all strips at once."""
    te, to, de, do = act1d_taps()
    b, t, c = x.shape
    strips = -(-t // rows)
    n0 = torch.arange(strips) * rows
    interior = (n0 >= 5) & (n0 + rows + 5 <= t)

    def load(r):  # x rows r [strips] -> [b, strips, c]; edge strips clamp
        clamped = r.clamp(0, t - 1)
        assert torch.equal(clamped[interior], r[interior]), "interior strip left the sequence"
        return x[:, torch.where(interior, r, clamped)]

    def up_sums(xw, s):
        e, o = te[0] * xw[s], to[0] * xw[s]
        for m in range(1, 6):
            e = e + te[m] * xw[(s + m) % RING]
            o = o + to[m] * xw[(s + m) % RING]
        return snake_beta(e, p["alpha"], p["beta"]), snake_beta(o, p["alpha"], p["beta"])

    def edge_pair(k):  # pair k from x rows k-2 .. k+3, clamped
        return up_sums([x[:, [min(max(k - 2 + m, 0), t - 1)]] for m in range(RING)], 0)

    e_first, o_last = edge_pair(-1)[0], edge_pair(t - 1)[1]
    xw, es, os_ = [None] * RING, [None] * RING, [None] * RING
    for q in range(5):
        xw[q] = load(n0 - 5 + q)
    y = torch.empty(b, strips, rows, c)
    for step in range(rows + 5):
        s = step % RING
        xw[(s + 5) % RING] = load(n0 + step)
        e, o = up_sums(xw, s)
        k = n0 - 3 + step
        assert bool(((k >= 0) & (k + 1 < t))[interior].all()), "interior strip replaced a pair"
        edge = (~interior)[None, :, None]
        e = torch.where(edge & (k + 1 < 0)[None, :, None], e_first,
                        torch.where(edge & (k + 1 >= t)[None, :, None], o_last, e))
        o = torch.where(edge & (k < 0)[None, :, None], e_first,
                        torch.where(edge & (k >= t)[None, :, None], o_last, o))
        es[s], os_[s] = e, o
        if step >= 5:
            ye = de[0] * es[(s + 1) % RING]
            yo = do[0] * os_[(s + 1) % RING]
            for m in range(1, 6):
                ye = ye + de[m] * es[(s + 1 + m) % RING]
                yo = yo + do[m] * os_[(s + 1 + m) % RING]
            y[:, :, step - 5] = ye + yo
    return y.reshape(b, strips * rows, c)[:, :t]  # an edge strip writes rows < T only


def _inputs(t, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    x[0] *= 30.0
    x[1] *= 0.01
    p = {k: torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
         for k in ("alpha", "beta")}
    return torch.from_numpy(x), p


@pytest.mark.parametrize("c", [4, 20, 48])
@pytest.mark.parametrize("per_r,plus", [(0, 1), (0, 2), (0, 5), (0, 6), (0, 7), (1, -1),
                                        (1, 0), (1, 1), (3, 5)])
@pytest.mark.parametrize("rows", act1d.STRIP_ROWS)
def test_strip_walk_is_bitwise_the_plain_version(rows, per_r, plus, c):
    """B = 2 at scales 30 and 0.01 (a halo that read the other sequence
    would show), T around one strip and below the warm-up, C unaligned to
    every vector width but 1 (20) and to none (48)."""
    t = per_r * rows + plus  # T = 1, 2, 5, 6, 7, R-1, R, R+1, 3R+5
    x, p = _inputs(t, c, seed=rows + t + c)
    got, want = strip_walk(x, p, rows), activation1d_fused(x, p)
    assert torch.equal(got, want), float((got - want).abs().max())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_encoder_shapes_are_the_default_encoders():
    """``chip_smoke.ENCODER_SHAPES`` (the shapes the rule is held to) are G's
    inputs in ``EncoderConfig()``'s acoustic encoder on a 22 s prompt."""
    cfg = EncoderConfig()
    t = pad_wav_for_encode(np.zeros((1, 22 * 16000), np.float32), cfg.hop_length).shape[1]
    c, want = cfg.num_generator_features, []
    for stride in cfg.up_ratios:
        want.append((t, c, 2 * len(cfg.dilations) + 1))  # two per residual unit, one before the down conv
        t, c = t // stride, 2 * c
    want.append((t, c, 1))
    got = [(t, c, n) for _, t, c, n in _chip_smoke().ENCODER_SHAPES]
    assert got == want


def test_launch_rows_fill_the_card_at_every_encoder_shape():
    """Every encoder shape gets the resident warps per SM the rule promises,
    from a compiled R that is whole trips."""
    compiled = {int(r) for r in re.findall(
        r"case (\d+): return launch<", (ROOT / "tts_max_tpu_torch/csrc/act1d.cu").read_text())}
    assert compiled == set(act1d.STRIP_ROWS)
    for _, t, c, _ in _chip_smoke().ENCODER_SHAPES:
        rows = act1d.launch_rows(1, t, c)
        assert rows in compiled and rows % RING == 0
        assert act1d.launch_warps(1, t, c, rows) >= act1d.WARPS_PER_SM * act1d.SMS


@pytest.mark.parametrize("b,t,c", [(1, 1, 4), (2, 7, 20), (1, 3000, 48), (8, 3000, 48),
                                   (3, 100000, 6)])
def test_launch_rows_take_the_longest_strip_that_fills(b, t, c):
    """Small inputs take the shortest strip; larger ones the longest that
    still fills every SM's resident warps."""
    rows = act1d.launch_rows(b, t, c)
    fills = [r for r in act1d.STRIP_ROWS
             if act1d.launch_warps(b, t, c, r) >= act1d.WARPS_PER_SM * act1d.SMS]
    assert rows == (max(fills) if fills else min(act1d.STRIP_ROWS))
