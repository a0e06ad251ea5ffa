"""The port's quantization-quality harness
(``tts_max_tpu_torch.tools.quant_quality``) against the JAX package's
``tools/quant_quality.py`` on the trained anchor fixture
(``tests/fixtures/quant_anchor.npz``) in fp32: for int8, int4 and int4-g64,
top-1 and top-8 agreement and the greedy divergence and match equal JAX's,
the hidden-state SNR within 0.01 dB and the logit RMSE within 1%; the
fixture and its prompts as the port's tool reads them equal JAX's loader's;
and the CLI on a tiny random model prints a row a mode."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures.load_quant_anchor import load_anchor, make_anchor_prompts
from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models import quantization as jq
from tts_max_tpu_torch.models import quantization as tq
from tts_max_tpu_torch.tools import quant_quality
from tts_max_tpu_torch.training.optim import tree_items, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, STEPS = 4, 32, 16


def _jax_tool():
    sys.path.insert(0, ROOT)
    try:
        from tools import quant_quality as jqq
    finally:
        sys.path.remove(ROOT)
    return jqq


@pytest.fixture(scope="module")
def anchor():
    jparams, jcfg = load_anchor(dtype=jnp.float32)
    tparams, tcfg = quant_quality.load_anchor("cpu", torch.float32)
    toks = quant_quality.make_anchor_prompts(B, P, tcfg.vocab_size, 0)
    np.testing.assert_array_equal(toks, make_anchor_prompts(B, P, jcfg.vocab_size, 0))
    return jparams, jcfg, tparams, tcfg, toks


def test_anchor_reads_as_jax_loads_it(anchor):
    jparams, jcfg, tparams, tcfg, _ = anchor
    assert (tcfg.vocab_size, tcfg.dim, tcfg.n_layers, tcfg.head_dim) == (
        jcfg.vocab_size, jcfg.dim, jcfg.n_layers, jcfg.head_dim)
    flat = {"/".join(str(p.key) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = dict(tree_items(tparams))
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("mode", ["int8", "int4", "int4-g64"])
def test_agreement_and_divergence_match_jax(anchor, mode):
    jparams, jcfg, tparams, tcfg, toks = anchor
    jqq = _jax_tool()
    jqp = jq.quantize_for_serving(jparams, mode)
    ref = jqq.agreement(jqp, jparams, jcfg, jnp.asarray(toks))
    jdiv = jqq.greedy_divergence(jqp, jparams, jcfg, jnp.asarray(toks),
                                 jnp.full((B,), P, jnp.int32), STEPS)
    tqp = tq.quantize_for_serving(tree_map(lambda t: t, tparams), mode)
    tokens = torch.from_numpy(toks)
    ours = quant_quality.agreement(tqp, tparams, tcfg, tokens)
    div = quant_quality.greedy_divergence(tqp, tparams, tcfg, tokens,
                                          torch.full((B,), P, dtype=torch.int32), STEPS)
    assert ours[0] == pytest.approx(ref[0], abs=1e-9)  # top-1
    assert ours[1] == pytest.approx(ref[1], abs=1e-9)  # top-8
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-2)  # logit RMSE
    assert abs(ours[3] - ref[3]) <= 0.01, (ours[3], ref[3])  # SNR dB
    assert div == pytest.approx(jdiv, abs=1e-9)
    assert ours[0] > 0.5 and ours[3] > 5  # the trained margins hold


def test_cli_prints_a_row_per_mode(capsys):
    rows = quant_quality.main(["--arch", "llama-tiny", "--modes", "int8,int4-g64",
                               "--batch", "2", "--prompt", "16", "--steps", "4",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "random init" in out and "NOTE: random-init" in out
    assert [r["mode"] for r in rows] == ["int8", "int4-g64"]
    for r in rows:
        assert np.isfinite([r["snr_db"], r["top1"], r["top8"], r["rmse"], r["div"]]).all()
        assert 0 <= r["div"] <= 4 and 0 <= r["match"] <= 1
    assert rows[0]["snr_db"] > rows[1]["snr_db"]  # int8 beats int4
