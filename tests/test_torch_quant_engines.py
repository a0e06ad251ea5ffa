"""Greedy ids through the port's contiguous and paged engines on a
weight-only quantized model, identical to the JAX engines', in every
serving mode, with the configs and the ``quantized`` fixture of
``test_torch_quant.py`` (weights quantized by each package).
"""

import numpy as np
import pytest

from _torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_quant import (  # noqa: F401  (quantized: the shared fixture)
    GREEDY,
    VOCAB,
    WINDOW,
    quantized,
)
from tts_max_tpu.inference import engine as je
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch.inference import engine as te
from tts_max_tpu_torch.ops import sampling as ts


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_quantized_engines_match_jax(quantized, paged):
    """Greedy ids through the contiguous and the paged engine (5 requests,
    2 slots, K = 4, a vocab window), each mode."""
    mode, jcfg, jp, tcfg, tp = quantized
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, n).astype(np.int32) for n in (5, 40, 12, 23, 9)]
    kw = dict(max_batch=2, max_len=128, steps_per_dispatch=4, vocab_window=WINDOW)
    if paged:
        kw["block_size"] = 16
    jcls, tcls = ((je.PagedInferenceEngine, te.PagedInferenceEngine) if paged
                  else (je.InferenceEngine, te.InferenceEngine))
    jeng = jcls(jp, jcfg, sp=js.SamplingParams(**GREEDY), delta_kv=False, **kw)
    teng = tcls(tp, tcfg, sp=ts.SamplingParams(**GREEDY), device="cpu", **kw)

    def run(eng):
        ids = [eng.submit(p, max_new_tokens=9, eos_id=-1) for p in prompts]
        done = {c.request_id: np.asarray(c.tokens).tolist() for c in eng.run()}
        return [done[i] for i in ids]

    ours, ref = run(teng), run(jeng)
    assert ours == ref and all(len(t) == 9 for t in ours)
