"""Weight-only int8/int4 quantization in the port against the JAX package's,
on the CPU.

Inputs come from numpy seeds and go through both packages. The quantized
leaves (``quantize_tensor`` at 8 and 4 bits, per channel and grouped, 2-D
and stacked; ``_pack4`` / ``unpack_q4``; the whole ``quantize_llama_params``
tree in every serving mode) must be bitwise equal to JAX's. The compute
helpers run the plain versions here (CPU tensors): ``dequantize`` and
``embed_lookup`` are bitwise equal to JAX's; ``matmul`` and
``tied_logits`` agree within ``TOL`` (fp32: 1e-5 + 1e-5 |ref|; bf16: 2^-7
|ref| + 2^-9 max|ref|, one bf16 ulp for each of the two roundings of the
JAX formula, ``x @ q`` and ``x scale``, plus the order of the fp32 sums
under a rounding boundary). A quantized model's forward, prefill and
decode logits agree within the fp32 tolerance, and greedy ids through
``generate`` and both engines are identical to JAX's in every mode.

Configs: ``tiny_config`` (dim 64) for int8, int4 and int4-g64; dim 128 and
ffn 256 for int4-g128, whose groups must divide every contraction dim.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.inference import engine as je
from tts_max_tpu.inference import generate as jg
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models import quantization as jq
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.inference import engine as te
from tts_max_tpu_torch.inference import generate as tg
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models import quantization as tq
from tts_max_tpu_torch.ops import sampling as ts

VOCAB = 256
WINDOW = (40, 180)
GREEDY = dict(temperature=0.0, repetition_penalty=1.3, frequency_penalty=0.2)
MODES = {"int8": dict(bits=8), "int4": dict(bits=4),
         "int4-g64": dict(bits=4, group_size=64), "int4-g128": dict(bits=4, group_size=128)}
TOL = {torch.float32: (1e-5, 1e-5, 0.0), torch.bfloat16: (2.0 ** -7, 0.0, 2.0 ** -9)}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _assert_close(ours: torch.Tensor, ref, what: str) -> None:
    """|ours - ref| <= atol + rtol |ref| + rel_max max|ref|, with ``TOL`` of
    ours' dtype."""
    rtol, atol, rel_max = TOL[ours.dtype]
    a = ours.float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert a.shape == b.shape, what
    err = np.abs(a - b)
    bound = atol + rtol * np.abs(b) + rel_max * np.abs(b).max()
    assert (err <= bound).all(), (f"{what}: max err {err.max():.3e}, "
                                  f"{(err / bound).max():.2f}x the tolerance")


def _weights(rng, shape) -> np.ndarray:
    """Gaussian weights whose columns differ in scale, with outliers (so
    the min-MSE clip search picks ratios below 1 in some channels)."""
    w = rng.standard_normal(shape) * rng.uniform(0.05, 2.0, shape[-1:])
    mask = rng.random(shape) < 0.01
    return np.where(mask, w * 6, w).astype(np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_bitwise(ours, ref) -> None:
    """Every leaf bitwise equal; a mismatch names the leaf and the groups
    (channels) whose scales differ."""
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(ours) == sorted(ref)
    for name, a in ours.items():
        a, b = _as_np(a), _as_np(ref[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        bad = np.argwhere(a != b)
        assert len(bad) == 0, f"{name}: {len(bad)} entries differ, first at {bad[:8].tolist()}"


def _configs(mode: str, tied: bool = True):
    over = (dict(dim=128, ffn_dim=256, n_heads=4, n_kv_heads=2, head_dim=32)
            if mode == "int4-g128" else {})
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=VOCAB), dtype=jnp.float32,
                               tie_embeddings=tied, **over)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=VOCAB), dtype=torch.float32,
                               tie_embeddings=tied, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=list(MODES))
def quantized(request):
    """(mode, JAX cfg, JAX quantized params, port cfg, port quantized params):
    the same fp32 weights quantized by each package, tied head."""
    mode = request.param
    jcfg, tcfg = _configs(mode)
    jp = jl.init_params(jax.random.PRNGKey(5), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    return (mode, jcfg, jq.quantize_llama_params(jp, **MODES[mode]), tcfg,
            tq.quantize_llama_params(tp, **MODES[mode]))


# --- the quantized leaves ---------------------------------------------------------


@pytest.mark.parametrize("shape,axis,bits,group", [
    ((64, 48), 0, 8, None),
    ((64, 48), 0, 4, None),
    ((3, 128, 96), 1, 8, None),
    ((3, 128, 96), 1, 4, None),
    ((3, 128, 96), 1, 4, 64),
    ((2, 256, 64), 1, 4, 128),
    ((96, 64), 1, 8, None),  # an embedding, per row
    ((96, 64), 1, 4, None),
])
def test_quantize_tensor_bitwise_equal_to_jax(shape, axis, bits, group):
    w = _weights(np.random.default_rng(sum(shape) + bits), shape)
    ref = jq.quantize_tensor(jnp.asarray(w), axis, bits=bits, group_size=group)
    ours = tq.quantize_tensor(torch.from_numpy(w), axis, bits=bits, group_size=group)
    _assert_trees_bitwise(ours, ref)
    if bits == 4:  # the clip search chose ratios below 1 somewhere
        amax = np.abs(w).max(axis=axis if group is None else None)
        assert group is not None or (ours["scale"].numpy() < amax / 7 * 0.99).any()


def test_pack4_and_unpack_q4_bitwise_equal_to_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, (5, 12)).astype(np.float32)
    packed = tq._pack4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq._pack4(jnp.asarray(q))))
    # low nibble first, pairs along the last axis: columns that differ
    b = packed.numpy().astype(np.int32)
    lo, hi = b & 15, b >> 4
    np.testing.assert_array_equal(np.where(lo > 7, lo - 16, lo), q[:, 0::2])
    np.testing.assert_array_equal(np.where(hi > 7, hi - 16, hi), q[:, 1::2])
    raw = rng.integers(0, 256, (3, 4, 10), dtype=np.uint8)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ours = tq.unpack_q4(torch.from_numpy(raw), dt)
        ref = jq.unpack_q4(jnp.asarray(raw), jdt)
        assert ours.dtype == dt and tuple(ours.shape) == (3, 4, 20)
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(tq.unpack_q4(packed, torch.float32).numpy(), q)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_llama_params_bitwise_equal_to_jax(mode, tied):
    jcfg, tcfg = _configs(mode, tied)
    jp = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    ours = tq.quantize_llama_params(tp, **MODES[mode])
    _assert_trees_bitwise(ours, jq.quantize_llama_params(jp, **MODES[mode]))
    emb = ours["embed"]["embedding"]
    assert emb["q"].dtype == torch.int8 and emb["scale"].shape == (VOCAB,)
    if not tied:  # the head stays int8 in every mode
        assert ours["lm_head"]["kernel"]["q"].dtype == torch.int8
    wq = ours["layers"]["attn"]["wq"]["kernel"]
    assert ("q4" in wq) == (MODES[mode]["bits"] == 4)
    assert tq.is_grouped(wq) == ("group_size" in MODES[mode])
    assert ours["norm"]["scale"] is tp["norm"]["scale"]


@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_for_serving(mode):
    """In place, leaf by leaf: the same tree as ``quantize_llama_params``.
    JAX's ``quantize_for_serving`` runs under one jit, where XLA turns the
    division by the level count into a product with its fp32 reciprocal:
    its levels are the port's bit for bit, some scales one fp32 ulp off,
    or two for int4, whose clip ratio multiplies too (as they are from
    JAX's own ``quantize_llama_params``)."""
    jcfg, tcfg = _configs(mode)
    jp = jl.init_params(jax.random.PRNGKey(2), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    want = tq.quantize_llama_params(tp, **MODES[mode])
    kernel = tp["layers"]["mlp"]["w_up"]
    got = tq.quantize_for_serving(tp, mode)
    assert got is tp and tq.is_quantized(kernel["kernel"])  # updated in place
    _assert_trees_bitwise(got, want)
    ref = dict(_leaves(jq.quantize_for_serving(jp, mode)))
    for name, a in _leaves(got):
        b = np.asarray(ref[name])
        if name.endswith("scale") and a.dtype == torch.float32 and "norm" not in name:
            np.testing.assert_array_max_ulp(a.numpy(), b, maxulp=1 if MODES[mode]["bits"] == 8 else 2)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert tq.quantize_for_serving(tp, "") is tp


# --- the compute helpers ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_compute_helpers_match_jax(quantized, dtype):
    """``dequantize`` and ``embed_lookup`` bitwise; ``matmul`` (every layer
    kernel, x [3, 5, K]) and ``tied_logits`` within ``TOL``."""
    mode, _, jp, _, tp = quantized
    rng = np.random.default_rng(7)
    jdt = _JDT[dtype]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        grp = "attn" if name.startswith("w") and len(name) == 2 else "mlp"
        jk = jax.tree_util.tree_map(lambda a: a[1], jp["layers"][grp][name]["kernel"])
        tk = {k: v[1] for k, v in tp["layers"][grp][name]["kernel"].items()}
        np.testing.assert_array_equal(
            tq.dequantize(tk, dtype).float().numpy(),
            np.asarray(jq.dequantize(jk, jdt), np.float32), err_msg=name)
        k = tq.dequantize(tk, torch.float32).shape[0]
        x = rng.standard_normal((3, 5, k)).astype(np.float32)
        xt = torch.from_numpy(x).to(dtype)
        ours = tq.matmul(xt, tk)
        assert ours.dtype == dtype
        _assert_close(ours, jq.matmul(jnp.asarray(x).astype(jdt), jk), f"{mode} {name}")
    emb_t, emb_j = tp["embed"]["embedding"], jp["embed"]["embedding"]
    tokens = rng.integers(0, VOCAB, (2, 7))
    np.testing.assert_array_equal(
        tq.embed_lookup(emb_t, torch.from_numpy(tokens), dtype).float().numpy(),
        np.asarray(jq.embed_lookup(emb_j, jnp.asarray(tokens), jdt), np.float32))
    h = rng.standard_normal((4, emb_t["q"].shape[1])).astype(np.float32)
    ours = tq.tied_logits(torch.from_numpy(h).to(dtype), emb_t)
    assert ours.dtype == torch.float32
    _assert_close(ours.to(dtype), jq.tied_logits(jnp.asarray(h).astype(jdt), emb_j),
                  f"{mode} tied_logits")


def test_int4_embedding_lookup_and_tied_logits_match_jax():
    """An int4 embedding (``embed_bits=4``): rows unpacked along D."""
    jcfg, tcfg = _configs("int4")
    jp = jq.quantize_llama_params(jl.init_params(jax.random.PRNGKey(4), jcfg), bits=4,
                                  embed_bits=4)
    emb_j = jp["embed"]["embedding"]
    emb_t = {k: torch.from_numpy(np.array(v)) for k, v in emb_j.items()}
    assert "q4" in emb_t and emb_t["q4"].shape == (VOCAB, jcfg.dim // 2)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, VOCAB, (3, 4))
    np.testing.assert_array_equal(
        tq.embed_lookup(emb_t, torch.from_numpy(tokens), torch.float32).numpy(),
        np.asarray(jq.embed_lookup(emb_j, jnp.asarray(tokens), jnp.float32)))
    h = rng.standard_normal((5, jcfg.dim)).astype(np.float32)
    _assert_close(tq.tied_logits(torch.from_numpy(h), emb_t),
                  jq.tied_logits(jnp.asarray(h), emb_j), "int4 tied_logits")


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("bits", [8, 4])
def test_slice_logits_head_matches_jax(tied, bits):
    """The head window of a quantized model, tied (embedding rows) or
    untied (kernel columns; an int4 lm_head, ``embed_bits=4``, packs vocab
    pairs along them): the same levels and scales as JAX's, and logits
    through it within ``TOL``; odd bounds of an int4 lm_head raise."""
    jcfg, tcfg = _configs("int8", tied)
    jp = jq.quantize_llama_params(jl.init_params(jax.random.PRNGKey(6), jcfg), bits=bits,
                                  embed_bits=bits)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    lo, size = WINDOW
    ours = tl.slice_logits_head(tp, tcfg, lo, size)
    ref = jl.slice_logits_head(jp, jcfg, lo, size)
    _assert_trees_bitwise({k: v.contiguous() for k, v in ours.items()}, ref)
    h = np.random.default_rng(3).standard_normal((2, tcfg.dim)).astype(np.float32)
    head = tl._logits(torch.from_numpy(h), tp, tcfg, ours)
    _assert_close(head, jl._logits(jnp.asarray(h), jp, jcfg, ref), "window logits")
    if bits == 4 and not tied:
        for bad in ((41, 180), (40, 181)):
            with pytest.raises(ValueError, match="even"):
                tl.slice_logits_head(tp, tcfg, *bad)
            with pytest.raises(ValueError, match="even"):
                jl.slice_logits_head(jp, jcfg, *bad)


# --- through the model ----------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_model_logits_match_jax(mode, tied):
    """forward, windowed prefill and two decode steps (contiguous and
    paged) of the quantized model, fp32, within ``TOL``."""
    jcfg, tcfg = _configs(mode, tied)
    jp = jq.quantize_llama_params(jl.init_params(jax.random.PRNGKey(8), jcfg),
                                  **MODES[mode])
    tp = tq.quantize_llama_params(convert.llama_from_numpy(
        jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(8), jcfg)),
        tcfg, device="cpu"), **MODES[mode])
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


def test_quantized_generate_matches_jax(quantized):
    """Greedy ids through ``generate`` (vocab window, penalties), each mode."""
    mode, jcfg, jp, tcfg, tp = quantized
    toks = np.random.default_rng(0).integers(0, VOCAB, (2, 20)).astype(np.int32)
    lengths = np.asarray([20, 13], np.int32)
    kw = dict(max_new_tokens=12, eos_id=-1, vocab_window=WINDOW)
    ref = jg.generate(jp, jcfg, jnp.asarray(toks), jnp.asarray(lengths),
                      jax.random.PRNGKey(0), sp=js.SamplingParams(**GREEDY), **kw)
    ours = tg.generate(tp, tcfg, toks, lengths, None, sp=ts.SamplingParams(**GREEDY),
                       device="cpu", **kw)
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    assert ours.steps == 12


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
