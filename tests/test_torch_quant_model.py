"""A weight-only quantized model's logits in the port against the JAX
package's, on the CPU, in every serving mode and tied or untied: the same
fp32 weights, quantized by each package, give forward, prefill and decode
logits (contiguous and paged) within the fp32 ``TOL`` of
``test_torch_quant.py``, which holds the quantized leaves, the compute
helpers, ``generate`` and the configs used here
(``test_torch_quant_engines.py`` the engines).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_quant import MODES, VOCAB, WINDOW, _assert_close, _configs
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models import quantization as jq
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models import quantization as tq


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_model_logits_match_jax(mode, tied):
    """forward, windowed prefill and two decode steps (contiguous and
    paged) of the quantized model, fp32, within ``TOL``."""
    jcfg, tcfg = _configs(mode, tied)
    fp32 = jl.init_params(jax.random.PRNGKey(8), jcfg)
    jp = jq.quantize_llama_params(fp32, **MODES[mode])
    tp = tq.quantize_llama_params(convert.llama_from_numpy(
        jax.tree_util.tree_map(np.asarray, fp32), tcfg, device="cpu"), **MODES[mode])
    rng = np.random.default_rng(11)
    toks = rng.integers(0, VOCAB, (2, 12)).astype(np.int32)
    _assert_close(tl.forward(tp, tcfg, torch.from_numpy(toks)),
                  jl.forward(jp, jcfg, jnp.asarray(toks)), "forward")
    hj, ht = jl.slice_logits_head(jp, jcfg, *WINDOW), tl.slice_logits_head(tp, tcfg, *WINDOW)
    lens = np.asarray([12, 7], np.int32)
    cj = jl.init_kv_cache(jcfg, 2, 32)
    ct = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    lj, cj = jl.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), cj, hj)
    lt, ct = tl.prefill(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens), ct, ht)
    _assert_close(lt, lj, "prefill")
    pool = tl.init_paged_kv_cache(tcfg, 8, 16, device="cpu")
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    for i, b in enumerate((0, 1)):
        small = tl.init_kv_cache(tcfg, 1, 32, device="cpu")
        tl.prefill(tp, tcfg, torch.from_numpy(toks[b:b + 1]), torch.from_numpy(lens[b:b + 1]),
                   small, ht)
        tl.scatter_prefill_to_blocks(pool, small, table[i])
    lt_len = torch.from_numpy(lens.copy())
    for step in range(2):
        nt = rng.integers(0, VOCAB, 2).astype(np.int32)
        dj, cj = jl.decode_step(jp, jcfg, cj, jnp.asarray(nt), jnp.asarray(lens + step), hj)
        dt, ct = tl.decode_step(tp, tcfg, ct, torch.from_numpy(nt), lt_len + step, ht)
        dp, pool = tl.decode_step_paged(tp, tcfg, pool, torch.from_numpy(nt), lt_len + step,
                                        table, use_pallas=False, logits_head=ht)
        _assert_close(dt, dj, f"decode step {step}")
        _assert_close(dp, dj, f"paged decode step {step}")
