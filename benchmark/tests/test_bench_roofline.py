"""The roofline counters against the bound column of PERF.md's kernel
table (``chip_smoke.py``'s formulas) at kernel C's e3 shape and A's and
A''s main shapes, and the whole-step counts at the cells' widths."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, roofline  # noqa: E402

E3_LENS = [431, 431, 431, 431, 496, 496, 1351, 1351]  # chip_smoke.py's e3 pool


def ms(flops_bytes):
    return 1e3 * roofline.least_seconds(*flops_bytes)


def test_kernel_a_main_shape():
    # S = 1280, Hq 32, Hkv 8, D 64, bf16: 6.7 GFLOP, 0.0068 ms by operations
    flops, nbytes = roofline.attn_fwd(1, 1280, 32, 8, 64)
    assert flops == pytest.approx(6.716e9, rel=1e-3)
    assert ms((flops, nbytes)) == pytest.approx(0.0068, abs=5e-5)
    # B = 8: 53.7 GFLOP, 0.0543 ms
    assert ms(roofline.attn_fwd(8, 1280, 32, 8, 64)) == pytest.approx(0.0543, abs=5e-5)


def test_kernel_a_prime_main_shape():
    # B = 4, S = 2048, Hq 32, D 64, bf16: 1.72e11 FLOP of five causal products, 0.1738 ms
    flops, nbytes = roofline.attn_bwd(4, 2048, 32, 8, 64)
    assert flops == pytest.approx(1.72e11, rel=2e-3)
    assert ms((flops, nbytes)) == pytest.approx(0.1738, abs=5e-5)
    # B = 8, S = 1024: 0.0869 ms
    assert ms(roofline.attn_bwd(8, 1024, 32, 8, 64)) == pytest.approx(0.0869, abs=5e-5)


def test_kernel_c_e3_shape():
    # B = 8, T = 2048, Hq 32, Hkv 8, D 64, bf16: 11.16 MB, 0.00333 ms by bytes
    flops, nbytes = roofline.decode_attn(E3_LENS, 32, 8, 64)
    assert nbytes == pytest.approx(11.16e6, rel=1e-3)
    assert ms((flops, nbytes)) == pytest.approx(0.00333, abs=5e-6)
    assert nbytes / roofline.PEAK_BYTES > flops / roofline.PEAK_FLOPS


def test_causal_pairs():
    assert roofline.causal_pairs(4) == 10  # 1 + 2 + 3 + 4 keys


@pytest.mark.parametrize("name, weights_gb, head_gb, kv_row", [
    ("smollm2-1.7b-speech", 3.22, 0.268, 196608),
    ("mistral-7b-v0.3-speech", 13.96, 0.537, 131072),
])
def test_decode_step_counts(name, weights_gb, head_gb, kv_row):
    """One decode step's bytes: the layer weights, the window head, one
    embedding row, and per layer each slot's new row and live rows."""
    cfg = harness.model_config(harness.load_json("configs", name))
    assert 2 * roofline.layer_matmul_params(cfg) / 1e9 == pytest.approx(weights_gb, rel=2e-3)
    assert 2 * 65542 * cfg.dim / 1e9 == pytest.approx(head_gb, rel=2e-3)
    one = roofline.decode_step(cfg, [1000], 65542)[1]
    two = roofline.decode_step(cfg, [1000, 1000], 65542)[1]
    assert two - one == 1001 * kv_row + 2 * cfg.dim  # a slot: its rows, its new row, its embedding


def test_train_flops():
    cfg = harness.model_config(harness.load_json("configs", "smollm2-1.7b-speech"))
    n = roofline.layer_matmul_params(cfg) + cfg.vocab_size * cfg.dim
    att = 3 * cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * (100 * 101 // 2)
    assert roofline.train_flops(cfg, [100]) == pytest.approx(6 * n * 100 + att)
