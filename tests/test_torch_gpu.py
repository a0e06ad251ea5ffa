"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each skips without a CUDA card (as everywhere on a CPU-only
machine). This file imports no JAX, so on the GPU machine, which has none,
it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import dataclasses

import pytest
import torch

from tts_max_tpu_torch.models.llama import _quantize_kv
from tts_max_tpu_torch.ops.act1d import STRIP_ROWS
from tts_max_tpu_torch.ops.attention import (
    KERNEL_TOL,
    causal_attention,
    decode_attention,
)
from tts_max_tpu_torch.ops.flash_attention import flash_attention
from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 128)])
def test_flash_attention_kernel_matches_plain(dtype, d):
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 150, h, d, generator=g, device="cuda").to(dtype)
               for h in (8, 2, 2))
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal)
        ref = causal_attention(q, k, v, causal=causal)
        rtol, atol = KERNEL_TOL[dtype]
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


def _contiguous_case(g, b, t, hq, hkv, d, dtype, lens, quant=False):
    """q [b, hq, d] and layer 1 of stacked caches [2, b, t, hkv, d] (a view,
    as ``llama.decode_step`` passes ``cache[layer]``), bf16 or fp32, or int8
    with scales; NaN in every row past a length, in both layers (in the
    scales for int8)."""
    from tts_max_tpu_torch.models.llama import _layer_cache

    q = torch.randn(b, hq, d, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(2, b, t, hkv, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if quant:
        k, v = _quantize_kv(k), _quantize_kv(v)
    dead = torch.arange(t, device="cuda")[None, :] >= lengths[:, None]
    for c in (k, v):
        (c["scale"] if quant else c)[:, dead] = float("nan")
    return q, _layer_cache(k, 1), _layer_cache(v, 1), lengths


# (B, T, lengths): T = 200 is not a multiple of 32; lengths 1, 31, 32, 33
# and T sit around chunk edges (0 gives zeros, in B's plain version too)
_DECODE_LENGTHS = [(7, 200, [0, 1, 31, 32, 33, 200, 137]),
                   (8, 2048, [431, 431, 431, 431, 496, 496, 1351, 1351]),
                   (1, 1536, [1359])]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,lens", _DECODE_LENGTHS)
@pytest.mark.parametrize("hq", [8, 32, 64])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_kernel_matches_plain(d, quant, hq, b, t, lens):
    """Kernel B (bf16 q over a bf16 or int8 cache: the tensor cores) against
    its plain version: n_rep 1, 4 and 8 over 8 kv heads, D 64 and 128, a
    stacked cache's layer view, NaN past every length."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, lengths = _contiguous_case(g, b, t, hq, 8, d, torch.bfloat16, lens, quant)
    out = flash_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    ref = decode_attention(q, k, v, lengths)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    if 0 in lens:
        assert (out[lens.index(0)] == 0).all()


@pytest.mark.gpu
def test_decode_kernels_raise_on_a_misaligned_bf16_cache():
    """The tensor cores copy 16-byte pieces of each row: B and C raise on a
    bf16 cache that does not start on a 16-byte boundary (no fallback)."""
    _cuda()
    from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention

    b, t, hkv, d = 2, 64, 8, 64
    q = torch.zeros(b, 32, d, dtype=torch.bfloat16, device="cuda")
    good = torch.zeros(b, t, hkv, d, dtype=torch.bfloat16, device="cuda")
    bad = torch.zeros(b * t * hkv * d + 1, dtype=torch.bfloat16, device="cuda")[1:]
    bad = bad.view(b, t, hkv, d)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")
    for fn in (flash_decode_attention, ragged_decode_attention):
        with pytest.raises(ValueError, match="aligned"):
            fn(q, bad, good, lengths)
        with pytest.raises(ValueError, match="aligned"):
            fn(q, good, bad, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernel_matches_plain(quant):
    """The main case: B = 8, Hq 32, Hkv 8, D 64, bs 64, table width 32,
    ragged lengths over a shuffled pool of 257 blocks, NaN in the sink, in
    unowned pages and past every length; each entry point and the stacked
    form within KERNEL_TOL."""
    _cuda()
    from tts_max_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(0)
    b, p, bs, n = 8, 32, 64, 257
    lens = torch.tensor([300, 1900, 777, 1024, 1358, 501, 1650, 1100],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(b, 32, 64, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(2, n, bs, 8, 64, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(1))[:b * p] + 1
    table = perm.view(b, p).to(device="cuda", dtype=torch.int32)
    live = torch.zeros(n, bs, dtype=torch.bool, device="cuda")
    rows = torch.arange(p * bs, device="cuda")
    for i in range(b):
        ok = rows < lens[i]
        live[table[i].repeat_interleave(bs)[ok], (rows % bs)[ok]] = True
    if quant:
        k, v = _quantize_kv(k), _quantize_kv(v)
    for c in (k, v):
        (c["scale"] if quant else c)[:, ~live] = float("nan")

    def layer(c, i):
        return {"q": c["q"][i], "scale": c["scale"][i]} if quant else c[i]

    rtol, atol = KERNEL_TOL[torch.bfloat16]
    for i in range(2):
        ref = pa.paged_decode_attention_xla(q, layer(k, i), layer(v, i), table, lens)
        outs = [fn(q, layer(k, i), layer(v, i), table, lens)
                for fn in (pa.paged_decode_attention_dense, pa.paged_decode_attention_dma,
                           pa.paged_decode_attention)]
        outs.append(pa.paged_decode_attention_dense(q, k, v, table, lens, layer=i))
        for out in outs:
            torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


def _act1d_case(g, b, t, c):
    x = torch.randn(b, t, c, generator=g, device="cuda")
    x[0] *= 40.0
    x[-1] *= 0.01
    p = {k: 0.3 * torch.randn(c, generator=g, device="cuda") for k in ("alpha", "beta")}
    return x, p


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(1, 3000, 48), (2, 65, 4), (2, 1, 4), (1, 700, 96)]
                         + [(2, t, 4) for r in STRIP_ROWS for t in (r - 1, r + 1)]
                         + [(2, 3 * r + 5, 20) for r in STRIP_ROWS])
def test_act1d_kernel_matches_plain(b, t, c):
    """Kernel G against its plain version ``activation1d_fused`` on the card, fp32:
    sequences at different scales (a halo that read the other sequence
    would show), T around one strip, below the warm-up and past three
    strips, channels that fill no warp (C = 4) or not a whole one (C = 20)."""
    _cuda()
    from tts_max_tpu_torch.ops.act1d import activation1d_fused, activation1d_kernel

    x, p = _act1d_case(torch.Generator(device="cuda").manual_seed(0), b, t, c)
    rtol, atol = KERNEL_TOL[torch.float32]
    torch.testing.assert_close(activation1d_kernel(x, p), activation1d_fused(x, p),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", STRIP_ROWS)
def test_act1d_every_strip_length_matches_plain(rows, monkeypatch):
    """Each compiled R of kernel G, forced in place of the rule's choice, at
    T = 1, R + 1 and 3R + 5 (edge and interior strips) and at an
    encoder-like length, B = 2 at scales 40 and 0.01."""
    _cuda()
    from tts_max_tpu_torch.ops import act1d

    monkeypatch.setattr(act1d, "launch_rows", lambda b, t, c: rows)
    g = torch.Generator(device="cuda").manual_seed(rows)
    rtol, atol = KERNEL_TOL[torch.float32]
    for t in (1, rows + 1, 3 * rows + 5, 4000):
        x, p = _act1d_case(g, 2, t, 48)
        torch.testing.assert_close(act1d.activation1d_kernel(x, p),
                                   act1d.activation1d_fused(x, p), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,lens", _DECODE_LENGTHS)
@pytest.mark.parametrize("hq", [8, 32, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_decode_kernel_matches_plain(dtype, d, hq, b, t, lens):
    """Kernel C against its plain version on the card (bf16 on the tensor
    cores with q split hi/lo, fp32 on the CUDA cores): n_rep 1, 4 and 8 over
    8 kv heads, D 64 and 128, a stacked cache's layer view, lengths 0, 1,
    31, 32, 33 and T, NaN in every row past a length (the kernel never
    reads them), exact zeros at length 0."""
    _cuda()
    from tts_max_tpu_torch.ops.attention import ragged_decode_attention_plain
    from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, lengths = _contiguous_case(g, b, t, hq, 8, d, dtype, lens)
    out = ragged_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    ref = ragged_decode_attention_plain(q, k, v, lengths)
    rtol, atol = KERNEL_TOL[dtype]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    if 0 in lens:
        assert (out[lens.index(0)] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,kv_len", [
    (8, 137, 64, 8, 128, False, 100),   # B = 8, D = 128, n_rep 8, kv_len < S, non-causal
    (8, 137, 64, 8, 128, True, 100),    # the same, causal
    (1, 200, 8, 8, 64, True, 200),      # n_rep 1, S not a multiple of 64
])
def test_flash_attention_tensor_cores_edge_cases(b, s, hq, hkv, d, causal, kv_len):
    """Kernel A's bf16 (tensor-core) path against its plain version: batch 8,
    D = 128, n_rep 1 and 8, a masked tail of keys, a partial last q tile."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    ref = causal_attention(q, k, v, causal=causal, kv_len=kv_len)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


def _paged_case(g, b, hq, d, bs, lens, quant, p, n=97, hkv=8):
    """A shuffled pool of ``n`` blocks of ``bs`` rows, NaN in the sink block,
    in unowned pages and past every length (in the scales for int8)."""
    q = torch.randn(b, hq, d, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(n, bs, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(bs))[:b * p] + 1
    table = perm.view(b, p).to(device="cuda", dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = torch.zeros(n, bs, dtype=torch.bool, device="cuda")
    rows = torch.arange(p * bs, device="cuda")
    for i in range(b):
        ok = rows < lengths[i]
        live[table[i].repeat_interleave(bs)[ok], (rows % bs)[ok]] = True
    if quant:
        k, v = _quantize_kv(k), _quantize_kv(v)
    for c in (k, v):
        (c["scale"] if quant else c)[~live] = float("nan")
    return q, k, v, table, lengths


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,d,bs,quant,lens", [
    (1, 64, 128, 64, True, [1358]),                 # n_rep 8, D = 128, int8, batch 1
    (3, 32, 64, 8, False, [1, 300, 77]),            # bs 8: 24 of a chunk's 32 rows past the page
    (3, 32, 64, 16, True, [16, 301, 77]),           # bs 16, int8
    (3, 32, 64, 48, False, [47, 300, 97]),          # bs 48: a second chunk crosses the page end
])
def test_paged_kernel_block_sizes_and_gqa(b, hq, d, bs, quant, lens):
    """The tensor-core paged kernel through D, E and F against the plain
    version: every block size that worked before still works (32-row
    chunks, the rows past a small page's end masked), n_rep 8 at D = 128
    in int8."""
    _cuda()
    from tts_max_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(0)
    p = -(-max(lens) // bs) + 1
    q, k, v, table, lengths = _paged_case(g, b, hq, d, bs, lens, quant, p,
                                          n=b * p + 1 + 4)
    ref = pa.paged_decode_attention_xla(q, k, v, table, lengths)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    for fn in (pa.paged_decode_attention_dense, pa.paged_decode_attention_dma,
               pa.paged_decode_attention):
        torch.testing.assert_close(fn(q, k, v, table, lengths), ref, rtol=rtol, atol=atol)


def _quant_close(out, ref):
    from tts_max_tpu_torch.ops.quant_matmul import KERNEL_TOL

    rtol, atol = KERNEL_TOL[out.dtype]
    err = (out.float() - ref).abs()
    assert bool((err <= rtol * ref.abs() + atol * ref.abs().max()).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 9, 16])
@pytest.mark.parametrize("form", [dict(bits=8), dict(bits=4), dict(bits=4, group_size=64),
                                  dict(bits=4, group_size=128)],
                         ids=["int8", "int4", "int4-g64", "int4-g128"])
def test_quant_matmul_kernel_matches_plain(form, m, dtype):
    """kn against the plain version in fp32, columns that differ (a swapped
    nibble pair fails), N not a multiple of a tile's columns, rows of 776
    int8 or 388 int4 bytes (8- and 4-byte pieces); one and two n8 tiles."""
    _cuda()
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(m)
    w = torch.randn(512, 776, generator=g, device="cuda") * torch.linspace(
        0.1, 2.0, 776, device="cuda")
    p = quantize_tensor(w, 0, **form)
    x = torch.randn(m, 512, generator=g, device="cuda").to(dtype)
    before = qm.quant_matmul.launches
    out = qm.quant_matmul(x, p)
    assert out.dtype == dtype and qm.quant_matmul.launches == before + 1
    _quant_close(out, qm.matmul_plain(x.float(), p))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_head_kernels_match_plain(bits):
    """vd on a tied head window, and kn through an untied window's row
    stride (``llama.slice_logits_head``), against the plain versions."""
    _cuda()
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(bits)
    cfg = llama.tiny_config(vocab_size=700)
    emb = torch.randn(700, cfg.dim, generator=g, device="cuda")
    win = llama.slice_logits_head({"embed": {"embedding": quantize_tensor(emb, 1, bits=bits)}},
                                  cfg, 40, 610)
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    head = llama.slice_logits_head(
        {"lm_head": {"kernel": quantize_tensor(emb.T.contiguous(), 0, bits=bits)}}, untied,
        40, 610)
    for m in (1, 5, 9, 16):
        h = torch.randn(m, cfg.dim, generator=g, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            x = h.to(dtype)
            _quant_close(qm.quant_tied_logits(x, win), qm.tied_logits_plain(x.float(), win))
            _quant_close(qm.quant_matmul(x, head), qm.matmul_plain(x.float(), head))


@pytest.mark.gpu
@pytest.mark.parametrize("bits,group", [(8, None), (4, 128)], ids=["int8", "int4-g128"])
def test_quant_kernels_repeat_bitwise(bits, group):
    """Two launches of kn (split over a cluster of K ranges) and of vd give
    the same bits: the sums are added in a fixed order, with no atomics."""
    _cuda()
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(bits)
    p = quantize_tensor(torch.randn(2048, 512, generator=g, device="cuda"), 0, bits=bits,
                        group_size=group)
    assert qm.plan(16, 2048, 512, bits, group)[1] > 1  # the sums cross blocks
    emb = quantize_tensor(torch.randn(1000, 256, generator=g, device="cuda"), 1, bits=bits)
    for m in (1, 16):
        x = torch.randn(m, 2048, generator=g, device="cuda").bfloat16()
        assert torch.equal(qm.quant_matmul(x, p), qm.quant_matmul(x, p))
        h = torch.randn(m, 256, generator=g, device="cuda")
        assert torch.equal(qm.quant_tied_logits(h, emb), qm.quant_tied_logits(h, emb))


@pytest.mark.gpu
def test_quant_kernels_raise_on_what_they_do_not_take():
    _cuda()
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import quant_matmul as qm

    p = quantize_tensor(torch.randn(64, 64, device="cuda"), 0)
    x = torch.randn(2, 64, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        qm.quant_matmul(x, {"q": p["q"][:, 1:63], "scale": p["scale"][1:63]})
    with pytest.raises(ValueError, match="dtype"):
        qm.quant_matmul(x.half(), p)
    emb = quantize_tensor(torch.randn(64, 64, device="cuda"), 1)
    with pytest.raises(ValueError, match="16"):
        qm.quant_tied_logits(x[:, :40], {"q": emb["q"][:, :40], "scale": emb["scale"]})


def _small_lm(seed, layers=2):
    """A small fp32 model whose head_dim (64) the kernels take, on the card."""
    from tts_max_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=layers, n_heads=4,
                            n_kv_heads=2, head_dim=64, ffn_dim=512, dtype=torch.float32)
    return cfg, llama.init_params(cfg, seed=seed, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_prefill_ahead_on_the_card(paged):
    """A saturated 2-slot pool with prefill-ahead, sampled: every attached
    slot's first decode step re-derives its park preview (the engine raises
    otherwise), every request completes, the park rows are recycled, and the
    park prefills ran kernel A."""
    _cuda()
    import numpy as np

    from tts_max_tpu_torch.inference.engine import InferenceEngine, PagedInferenceEngine
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    cfg, params = _small_lm(11)
    cls = PagedInferenceEngine if paged else InferenceEngine
    extra = dict(block_size=64, enable_prefix_cache=True) if paged else {}
    eng = cls(params, cfg, max_batch=2, max_len=256, steps_per_dispatch=4,
              sp=SamplingParams(temperature=0.9, top_k=20), prefill_ahead=True, park_rows=4,
              **extra)
    eng.warmup(prompt_buckets=(64,))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (9, 40, 17, 70, 5, 33, 12, 60)]
    flash_attention.launches = 0
    done = eng.generate_all(prompts, max_new_tokens=24, eos_id=-1)
    st = eng.stats()
    assert [len(c.tokens) for c in done] == [24] * 8
    assert st["parked_total"] > 0 and st["free_park_rows"] == 4 and not eng.has_work()
    assert flash_attention.launches == cfg.n_layers * (eng._prefill_groups + eng._park_groups)
    assert eng._park_groups > 0
    if paged:
        assert len(eng._free_blocks) + len(eng._evictable) == eng.num_blocks - 1


@pytest.mark.gpu
def test_speculative_draft_equal_to_target_on_the_card():
    """fp32, draft = target, greedy: the ids equal greedy ``generate`` and
    every candidate is accepted; the prefills ran kernel A and the draft
    steps kernel B."""
    _cuda()
    import numpy as np

    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.inference.speculative import speculative_generate
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    cfg, params = _small_lm(12)
    toks = np.random.default_rng(1).integers(1, 512, (2, 20)).astype(np.int32)
    lens = [20, 20]
    sp = SamplingParams(temperature=0.0)
    flash_attention.launches = flash_decode_attention.launches = 0
    res = speculative_generate(params, cfg, params, cfg, toks, lens, None, sp=sp,
                               max_new_tokens=32, eos_id=-1, gamma=4)
    assert flash_attention.launches == 2 * cfg.n_layers
    assert flash_decode_attention.launches == (4 + 1) * res.steps * cfg.n_layers
    ref = generate(params, cfg, toks, lens, None, sp=sp, max_new_tokens=32, eos_id=-1)
    assert torch.equal(res.tokens, ref.tokens)
    assert res.steps == -(-31 // 5)


# --- training: kernel A' (attention's backward) and the autograd Function ------


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,d,dtype,kv_len,q_scale", [
    (2, 300, 32, 8, 64, torch.bfloat16, None, 1.0),
    (1, 200, 8, 8, 128, torch.float32, 137, 1.0),
    (1, 257, 16, 2, 64, torch.bfloat16, 200, 1.0),
    (2, 128, 8, 2, 128, torch.float32, None, 1.0),
    (1, 1024, 32, 8, 64, torch.bfloat16, None, 4.0),  # sharp: D needs the unrounded O
    (2, 130, 32, 8, 64, torch.bfloat16, 97, 1.0),     # partial tiles in both kernels
    (8, 1024, 32, 8, 64, torch.bfloat16, None, 1.0),
    (1, 333, 8, 2, 128, torch.bfloat16, 301, 4.0),    # D = 128 on the tensor cores
    (8, 512, 32, 8, 64, torch.bfloat16, None, 1.0),   # draft distillation's layer
    (2, 2048, 32, 8, 64, torch.bfloat16, None, 1.0),  # the LoRA step's layer
    # the GRPO update's layer (batch 8 there; 2 keeps the plain backward's
    # fp32 score matrices in memory)
    (2, 3072, 32, 8, 64, torch.bfloat16, None, 1.0),
])
def test_flash_attention_bwd_kernel_matches_plain(b, s, hq, hkv, d, dtype, kv_len, q_scale):
    """Kernel A' against the plain backward within GRAD_TOL: bf16 (tensor
    cores) and fp32, D 64 and 128, tails, kv_len < S, n_rep 1, 4 and 8, a
    sharp softmax (q x 4) and batch 8. Kernel A's output is the same with
    and without the log-sum-exp and residual writes, and out + out_lo is
    nearer the fp32 output than out alone."""
    from tts_max_tpu_torch.ops.attention import causal_attention_bwd, grad_tol_ratio
    from tts_max_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    _cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = (torch.randn(b, s, hq, d, generator=g, device="cuda") * q_scale).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    go = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    out, lse, out_lo = flash_attention_fwd(q, k, v, True, kv_len, with_lse=True)
    torch.testing.assert_close(out, flash_attention_fwd(q, k, v, True, kv_len)[0],
                               rtol=0, atol=0)
    assert (out_lo is None) == (dtype == torch.float32)
    if out_lo is not None:
        o32 = causal_attention(q.float(), k.float(), v.float(), kv_len=kv_len)
        err_hi = (out.float() - o32).abs().max()
        assert (out.float() + out_lo.float() - o32).abs().max() < err_hi / 16
    grads = flash_attention_bwd(q, k, v, out, lse, go, True, kv_len, out_lo)
    refs = causal_attention_bwd(q, k, v, go, kv_len=kv_len)
    for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
        assert x.dtype == dtype
        assert grad_tol_ratio(x, r) <= 1.0, name


@pytest.mark.gpu
def test_flash_attention_output_keeps_its_grad_fn_on_the_card():
    """On a CUDA input that requires grad the output stays in the graph, and
    the grads match the plain autograd Function on the CPU. (A wrapper that
    launched kernel A through ctypes and returned its output, as before the
    Function, fails the grad_fn assertion.)"""
    _cuda()
    g = torch.Generator(device="cpu").manual_seed(2)
    x = [torch.randn(2, 96, h, 64, generator=g) for h in (8, 2, 2)]
    go = torch.randn(2, 96, 8, 64, generator=g)
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v = (t.detach().to(dev).requires_grad_(True) for t in x)
        out = flash_attention(q, k, v)
        assert out.grad_fn is not None, dev
        (out * go.to(dev)).sum().backward()
        grads[dev] = (q.grad.cpu(), k.grad.cpu(), v.grad.cpu())
    from tts_max_tpu_torch.ops.attention import grad_tol_ratio

    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert grad_tol_ratio(a, r) <= 1.0


@pytest.mark.gpu
def test_every_parameter_gets_a_grad_on_the_card():
    """A 2-layer model's loss on the card gives every leaf a finite, non-zero
    grad; wq, wk, wv and attn_norm reach the loss only through attention."""
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.training import optim, train_step as ts

    _cuda()
    cfg = llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, max_seq_len=128, dtype=torch.bfloat16,
                            remat=True)
    params = llama.init_params(cfg, seed=0, device="cuda")
    ids = torch.randint(0, 256, (2, 100), device="cuda")
    _, _, grads = ts._loss_and_grads(params, cfg, {"input_ids": ids, "labels": ids}, 32)
    names = []
    for path, grad in optim.tree_items(grads):
        names.append(path)
        assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0, path
    for want in ("layers/attn/wq/kernel", "layers/attn/wk/kernel", "layers/attn/wv/kernel",
                 "layers/attn_norm/scale"):
        assert want in names


@pytest.mark.gpu
def test_flash_attention_raises_on_inputs_the_backward_does_not_take():
    _cuda()
    q, k, v = (torch.randn(1, 64, h, 64, device="cuda", requires_grad=True) for h in (4, 2, 2))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False)
    q32, k32, v32 = (torch.randn(1, 64, h, 32, device="cuda", requires_grad=True)
                     for h in (4, 2, 2))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q32, k32, v32)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(*(t.detach().half().requires_grad_(True) for t in (q, k, v)))


@pytest.mark.gpu
def test_distill_step_on_the_card_matches_the_cpu():
    """``distill_loss`` and its draft grads on the card (kernels A and A',
    fp32 on the CUDA cores, TF32 off) against the CPU's plain versions
    within GRAD_TOL; then one ``make_distill_step`` on the card launches A
    once a target layer (no training outputs) and once a draft layer, and A'
    once a draft layer."""
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.ops.attention import grad_tol_ratio
    from tts_max_tpu_torch.ops.flash_attention import flash_attention_bwd
    from tts_max_tpu_torch.training import distill, optim

    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=3, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, max_seq_len=128, dtype=torch.float32)
    target = llama.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 512, (2, 100), generator=g)
    mask = torch.arange(100)[None, :] < torch.tensor([[100], [71]])
    results = {}
    for dev in ("cpu", "cuda"):
        tp = optim.tree_map(lambda t: t.to(dev), target)
        draft, dcfg = distill.truncated_draft(tp, cfg, 1)
        leaves = []

        def track(p):
            q = p.detach().requires_grad_(True)
            leaves.append(q)
            return q

        live = optim.tree_map(track, draft)
        loss = distill.distill_loss(live, tp, toks.to(dev), mask.to(dev), draft_cfg=dcfg,
                                    target_cfg=cfg, chunk_size=32)
        grads = torch.autograd.grad(loss, leaves)
        results[dev] = (float(loss.detach()), [x.cpu() for x in grads])
    assert results["cuda"][0] == pytest.approx(results["cpu"][0], rel=1e-5)
    for a, r in zip(results["cuda"][1], results["cpu"][1]):
        assert grad_tol_ratio(a, r) <= 1.0

    tp = optim.tree_map(lambda t: t.to("cuda"), target)
    draft, dcfg = distill.truncated_draft(tp, cfg, 1)
    tx = optim.AdamW(1e-3, betas=(0.9, 0.95), weight_decay=0.01)
    step = distill.make_distill_step(dcfg, cfg, tx, chunk_size=32)
    flash_attention.launches = flash_attention_bwd.launches = 0
    new, _, loss, gnorm = step(draft, tp, tx.init(draft), toks, mask)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        cfg.n_layers + dcfg.n_layers, dcfg.n_layers)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
    assert float(loss) == pytest.approx(results["cpu"][0], rel=1e-5)
    assert not torch.equal(new["embed"]["embedding"], draft["embed"]["embedding"])


@pytest.mark.gpu
def test_stft_and_mel_on_the_card_match_the_cpu():
    """``stft`` (a window shorter than n_fft, the largest MSD resolution)
    and ``mel_spectrogram`` at the GAN mel loss's widest and narrowest
    resolutions, cuFFT against the CPU's FFT: within 1e-5 of the largest
    magnitude; the cached windows and filter banks live on the card."""
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.ops import stft

    _cuda()
    full_fp32()
    x = torch.randn(2, 25600, generator=torch.Generator().manual_seed(0)) * 0.3
    cases = [lambda t: stft.stft(t, 1024, 120, 600), lambda t: stft.stft(t, 2296, 1148, 2296),
             lambda t: stft.mel_spectrogram(t, 16000, 32, 8, 5),
             lambda t: stft.mel_spectrogram(t, 16000, 2048, 512, 320)]
    for fn in cases:
        ref, out = fn(x), fn(x.cuda())
        assert out.device.type == "cuda"
        assert (out.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.gpu
def test_gan_step_on_the_card_matches_the_cpu():
    """One GAN step of the tiny codec configs on the card (cuDNN conv2d,
    cuFFT, TF32 off) and on the CPU from the same weights and batch, Adam
    eps 1e-3 on both (as tests/test_torch_gan.py, so the first update is
    smooth in the grads): every metric within 1e-4 relative, every updated
    leaf within 1e-4 of max(|leaf|, 1) (one update moves a weight by up to
    lr = 1e-3)."""
    import numpy as np

    from tts_max_tpu_torch.core.config import CodecTrainingConfig
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.models.codec import discriminator as disc, vocos
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training.codec import gan

    _cuda()
    full_fp32()
    vcfg, mcfg, scfg = vocos.tiny_vocos_config(), disc.tiny_mpd_config(), disc.tiny_msd_config()
    cfg = CodecTrainingConfig(generator_lr=1e-3, discriminator_lr=1e-3)
    gp = vocos.init_decoder(vcfg, seed=4, device="cpu")
    dp = optim.tree_map(lambda t: t * 5.0, {"mpd": disc.init_mpd(mcfg, 1, "cpu"),
                                            "msd": disc.init_msd(scfg, 2, "cpu")})
    rng = np.random.default_rng(7)
    batch = {"audio_codes": rng.integers(0, 65536, (2, 16)).astype(np.int32),
             "wav": (0.1 * rng.standard_normal((2, 16 * 320))).astype(np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        gt, gf = gan.split_generator_params(optim.tree_map(lambda t: t.to(dev), gp))
        d = optim.tree_map(lambda t: t.to(dev), dp)
        txs = gan.create_gan_optimizers(cfg)
        for tx in txs:
            tx.eps = 1e-3
        step = gan.make_gan_step(vcfg, mcfg, scfg, cfg, gf, *txs)
        out[dev] = step(gt, d, txs[0].init(gt), txs[1].init(d),
                        {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    for a, b in zip(out["cuda"][-1], out["cpu"][-1]):
        assert bool(torch.isfinite(a)) and float(a) == pytest.approx(float(b), rel=1e-4)
    for i in (0, 1):
        ref = dict(optim.tree_items(out["cpu"][i]))
        for path, t in optim.tree_items(out["cuda"][i]):
            r = ref[path]
            assert (t.cpu() - r).abs().max() <= 1e-4 * max(float(r.abs().max()), 1.0), path


# --- RLHF: the GRPO step and the reward models -----------------------------------


@pytest.mark.gpu
def test_grpo_step_on_the_card_matches_the_cpu():
    """``grpo_loss`` and its grads on the card (kernels A and A', fp32 on
    the CUDA cores, TF32 off) against the CPU's plain versions: the loss
    within 1e-5, each grad within GRAD_TOL; then one ``make_grpo_step`` on
    the card launches A and A' once a layer and gives finite metrics."""
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.ops.attention import grad_tol_ratio
    from tts_max_tpu_torch.ops.flash_attention import flash_attention_bwd
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training.rlhf import grpo

    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, max_seq_len=128, dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 512, (4, 96), generator=g)
    mask = torch.zeros(4, 96, dtype=torch.bool)
    mask[:, 40:90] = True
    adv = torch.tensor([1.0, -1.0, 0.5, -0.5])
    results = {}
    for dev in ("cpu", "cuda"):
        leaves = []

        def track(p):
            q = p.detach().to(dev).requires_grad_(True)
            leaves.append(q)
            return q

        live = optim.tree_map(track, params)
        loss, _ = grpo.grpo_loss(live, toks.to(dev), mask.to(dev), adv.to(dev), None, cfg=cfg)
        grads = torch.autograd.grad(loss, leaves)
        results[dev] = (float(loss.detach()), [x.cpu() for x in grads])
    assert results["cuda"][0] == pytest.approx(results["cpu"][0], rel=1e-5, abs=1e-6)
    for a, r in zip(results["cuda"][1], results["cpu"][1]):
        assert grad_tol_ratio(a, r) <= 1.0

    p = optim.tree_map(lambda t: t.to("cuda"), params)
    tx = optim.AdamW(1e-4, betas=(0.9, 0.95), weight_decay=0.1, mu_dtype="bf16")
    step = grpo.make_grpo_step(cfg, tx, 0.0)
    flash_attention.launches = flash_attention_bwd.launches = 0
    new, _, m = step(p, tx.init(p), toks.cuda(), mask.cuda(), adv.cuda(), None)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (cfg.n_layers,
                                                                        cfg.n_layers)
    assert all(map(lambda x: x == x and abs(x) < float("inf"), m)) and m.grad_norm > 0
    assert not torch.equal(new["layers"]["attn"]["wq"]["kernel"],
                           p["layers"]["attn"]["wq"]["kernel"])


@pytest.mark.gpu
def test_whisper_greedy_on_the_card_matches_the_cpu():
    """A small fp32 Whisper's log-mel and encoder within 1e-4 and its greedy
    tokens and lengths identical, card against CPU."""
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.models import whisper
    from tts_max_tpu_torch.training import optim

    _cuda()
    full_fp32()
    cfg = whisper.WhisperConfig(n_mels=80, vocab_size=700, d_model=128, encoder_layers=2,
                                decoder_layers=2, num_heads=4, ffn_dim=256,
                                max_source_positions=100, max_target_positions=64,
                                decoder_start_token_id=600, eos_token_id=599)
    params = whisper.init_params(cfg, seed=0, device="cpu")
    wav = torch.randn(2, 32000, generator=torch.Generator().manual_seed(3)) * 0.1
    prompt = torch.tensor([[600, 601, 602], [600, 603, 602]], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = optim.tree_map(lambda t: t.to(dev), params)
        mel = whisper.log_mel_spectrogram(wav.to(dev), cfg.n_mels)
        enc = whisper.encode(p, cfg, mel)
        out[dev] = (mel.cpu(), enc.cpu(), *[t.cpu() for t in whisper.greedy_decode(
            p, cfg, enc, prompt.to(dev), 40)])
    for a, r in zip(out["cuda"][:2], out["cpu"][:2]):
        assert (a - r).abs().max() <= 1e-4 * max(float(r.abs().max()), 1.0)
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    assert torch.equal(out["cuda"][3], out["cpu"][3])


@pytest.mark.gpu
def test_onnx_graph_on_the_card_matches_the_cpu():
    """A conv / pool / batchnorm / Gemm graph through ``onnx_lite.run`` on
    the card and on the CPU within 1e-5; the float initializers live on the
    card, the shape-like ones on the host."""
    import numpy as np

    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.utils import onnx_lite as ox

    _cuda()
    full_fp32()
    r = np.random.default_rng(0)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    g = ox.parse_model(ox.build_model_bytes([
        ox.encode_node("Unsqueeze", ["x", "ax"], ["u"]),
        ox.encode_node("Conv", ["u", "w", "b"], ["c"], kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
        ox.encode_node("Relu", ["c"], ["rl"]),
        ox.encode_node("MaxPool", ["rl"], ["mp"], kernel_shape=[2, 2], strides=[2, 2]),
        ox.encode_node("BatchNormalization", ["mp", "s", "bb", "m", "v"], ["bn"]),
        ox.encode_node("AveragePool", ["bn"], ["ap"], kernel_shape=[3, 3], strides=[1, 1],
                       auto_pad=b"SAME_UPPER"),
        ox.encode_node("GlobalAveragePool", ["ap"], ["ga"]),
        ox.encode_node("Flatten", ["ga"], ["f"], axis=1),
        ox.encode_node("Gemm", ["f", "wd", "bd"], ["y"], transB=1)],
        ["x"], ["y"], {"ax": np.asarray([1], np.int64), "w": f32(8, 1, 3, 3), "b": f32(8),
                       "s": np.abs(f32(8)) + 0.5, "bb": f32(8), "m": f32(8),
                       "v": np.abs(f32(8)) + 0.5, "wd": f32(3, 8), "bd": f32(3)}))
    x = f32(2, 300, 120)
    (ref,) = ox.run(g, {"x": x}, "cpu")
    (out,) = ox.run(g, {"x": x}, "cuda")
    assert out.device.type == "cuda"
    assert (out.cpu() - ref).abs().max() <= 1e-5 * max(float(ref.abs().max()), 1.0)
    on_card = g.on_device[torch.device("cuda", torch.cuda.current_device())]
    assert on_card["w"].device.type == "cuda" and isinstance(on_card["ax"], np.ndarray)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["fsdp", "dp"])
def test_world_size_one_nccl_step_matches_the_one_device_step(strategy, monkeypatch):
    """One train step through an NCCL group of world size 1 (the mesh step:
    under fsdp every split leaf gathered and its grad reduce-scattered, the
    whole grads all-reduced) equals the one-device step on the card from the
    same fp32 weights and batch (two micro-steps, remat, the chunked loss).
    At world size 1 the collectives copy, sum one term and reduce over one
    rank, so the loss and tokens are equal; the grad norm adds the split
    leaves' squares after the whole ones' (an fp32 reassociation: rtol
    1e-6), which moves the clip scale and so the params by at most a few
    ulps of lr (atol 1e-7)."""
    import socket

    import numpy as np

    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
    from tts_max_tpu_torch.training import optim, train_step as ts

    _cuda()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    cfg = llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, rope_theta=10000.0,
                            use_llama3_rope_scaling=False, max_seq_len=128,
                            dtype=torch.float32, remat=True)  # the kernels' head_dim
    params = llama.init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (2, 2, 128)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :7] = -100
    batch = {"input_ids": ids, "labels": labels}
    tx = optim.create_optimizer(1e-3)
    p1, o1, m1 = ts.train_step(params, tx.init(params), batch, cfg=cfg, tx=tx,
                               loss_chunk_size=64)
    env = pmesh.initialize_distributed("cuda")
    try:
        mesh = pmesh.build_mesh((1, 1, 1), strategy)
        step = ts.make_train_step(mesh, cfg, tx, params, 1.0, 64)
        p, o = step.shard(params, tx.init(params))
        collectives.reset_counts()
        p2, o2, m2 = step(p, o, batch)
        calls = collectives.counts()
        p2 = step.layout.gather(p2)
    finally:
        pmesh.destroy_distributed(env)
    assert (m2.loss, m2.tokens) == (m1.loss, m1.tokens)
    assert m2.grad_norm == pytest.approx(m1.grad_norm, rel=1e-6)
    for (path, a), (_, b) in zip(optim.tree_items(p2), optim.tree_items(p1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=path)
    L, A = cfg.n_layers, 2
    split = 7 * L + 1 if strategy == "fsdp" else 0
    assert calls["all_gather"] == (1 + A * 2 * 7 * L if split else 0)
    assert calls["reduce_scatter_sum"] == (A * 7 * L + 1 if split else 0)
    assert calls["all_reduce_sum"] == (4 if split else 3)


def _nccl_world_of_one(monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_world_size_one_nccl_tp_engine_matches_the_engine_without_a_mesh(paged, monkeypatch):
    """The engine with ``mesh=`` a ``(1, 1, 1)`` tensor-parallel mesh in an
    NCCL group of world size 1 (the rank's one block a leaf; every
    row-parallel sum made over a group of one, which copies) gives the
    greedy ids of the same engine without a mesh, bf16, through kernels C
    (contiguous) and D (paged), with one row-parallel sum per embedding
    and per layer product of each forward."""
    import numpy as np

    from tts_max_tpu_torch.inference.engine import InferenceEngine, PagedInferenceEngine
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.ops.sampling import SamplingParams
    from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
    from tts_max_tpu_torch.parallel.sharding import ShardLayout

    _cuda()
    _nccl_world_of_one(monkeypatch)
    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, rope_theta=10000.0,
                            use_llama3_rope_scaling=False, max_seq_len=256)
    params = llama.init_params(cfg, seed=4, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, 512, n).astype(np.int32) for n in (5, 70, 9, 33)]
    cls, kw = (PagedInferenceEngine, {"block_size": 64}) if paged else (InferenceEngine, {})
    common = dict(max_batch=4, max_len=256, sp=SamplingParams(temperature=0.0),
                  steps_per_dispatch=4, vocab_window=(100, 300), device="cuda", **kw)
    ref = cls(params, cfg, **common).generate_all(prompts, 24, eos_id=-1)
    env = pmesh.initialize_distributed("cuda")
    try:
        mesh = pmesh.build_mesh((1, 1, 1), "tp")
        eng = cls(ShardLayout(params, mesh).shard(params), cfg, mesh=mesh, **common)
        collectives.reset_counts()
        got = eng.generate_all(prompts, 24, eos_id=-1)
        exits = collectives.counts_tp()["tensor_exit"]
    finally:
        pmesh.destroy_distributed(env)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    steps = sum(eng.stats()["dispatches_per_stage"].values()) * eng.steps_per_dispatch
    assert exits == (1 + 2 * cfg.n_layers) * (eng._prefill_groups + steps)


@pytest.mark.gpu
def test_world_size_one_nccl_tp_step_matches_the_one_device_step(monkeypatch):
    """One ``tp`` train step through an NCCL group of world size 1 (every
    leaf its one tensor block; the row-parallel sums, the entries' grad
    sums and the vocab-parallel cross entropy made over a group of one)
    against the one-device step on the card, fp32, from the same weights and
    batch (two micro-steps, remat, the chunked loss). The cross entropy
    reduces the same fp32 logits through max, sum and log in place of
    logsumexp: the loss within rtol 1e-6, the grad norm within 1e-5. The
    grads then differ in their last bits, and Adam's first update moves a
    near-zero grad's weight by lr times its sign: the params are held to
    ``test_torch_distributed``'s Adam allowance (every element within 2 lr
    + 2e-6, under 1% of them beyond 2e-6)."""
    import numpy as np

    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
    from tts_max_tpu_torch.training import optim, train_step as ts

    _cuda()
    _nccl_world_of_one(monkeypatch)
    cfg = llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, rope_theta=10000.0,
                            use_llama3_rope_scaling=False, max_seq_len=128,
                            dtype=torch.float32, remat=True)
    params = llama.init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (2, 2, 128)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :7] = -100
    batch = {"input_ids": ids, "labels": labels}
    tx = optim.create_optimizer(1e-3)
    p1, o1, m1 = ts.train_step(params, tx.init(params), batch, cfg=cfg, tx=tx,
                               loss_chunk_size=64)
    env = pmesh.initialize_distributed("cuda")
    try:
        mesh = pmesh.build_mesh((1, 1, 1), "tp")
        step = ts.make_train_step(mesh, cfg, tx, params, 1.0, 64)
        p, o = step.shard(params, tx.init(params))
        collectives.reset_counts()
        p2, o2, m2 = step(p, o, batch)
        calls = collectives.counts_tp()
        p2 = step.layout.gather(p2)
    finally:
        pmesh.destroy_distributed(env)
    assert m2.tokens == m1.tokens
    assert m2.loss == pytest.approx(m1.loss, rel=1e-6)
    assert m2.grad_norm == pytest.approx(m1.grad_norm, rel=1e-5)
    noisy = total = 0
    for (path, a), (_, b) in zip(optim.tree_items(p2), optim.tree_items(p1)):
        err = (a - b).abs()
        assert float(err.max()) <= 2 * 1e-3 + 2e-6, (path, float(err.max()))
        noisy, total = noisy + int((err > 2e-6).sum()), total + err.numel()
    assert noisy < 0.01 * total, (noisy, total)
    L, A, C = cfg.n_layers, 2, 2  # 127 shifted tokens in chunks of 64
    assert calls == dict(tensor_enter=A * (2 * L + C), tensor_exit=A * (1 + 3 * L),
                         all_reduce_max=A * 2 * C, broadcast=0)
