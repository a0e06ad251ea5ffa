"""The port's GRPO slice (``tts_max_tpu_torch/training/rlhf``) against the
JAX package's (``tts_max_tpu/training/rlhf``) on the CPU, in fp32, at a
tiny Llama over a byte tokenizer with a 256-code speech vocabulary.

- ``reward_utils`` (normalization, WER/CER, the ``normalize_*`` maps,
  ``eval_wer``, ``eval_similarity``) and ``edit_distance`` equal JAX's on a
  battery of inputs;
- ``TtsRLHFDataset`` items equal JAX's;
- ``compute_advantages`` is bitwise JAX's;
- chunked ``sequence_logprobs`` at chunk 0/8/16/64 within 1e-5;
- ``grpo_loss`` within 1e-5 and its grads within 1e-4 (of each leaf's
  largest |grad|) of ``jax.grad``, at beta 0 and 0.04;
- one ``make_grpo_step`` (AdamW, bf16 first moment) within 1e-5;
- two ``GRPOTrainer.train_step``s at temperature 0 with a stub reward:
  rollout ids identical, losses and params within 1e-5 (and with scripted
  rollouts each step's grads within 1e-4 of each leaf's largest);
- the three reward classes with stub backends and the spectral fallback
  within 1e-5 of JAX's, on the same seeded tiny Vocos decoder;
- after a step, a greedy engine rollout equals ``generate`` with the
  updated params (the engine gets the trainer's new weights and vocab
  window head; the JAX trainer without a topology keeps its first ones).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu.core.config import RLHFConfig as JRLHFConfig
from tts_max_tpu.data.samples import Sample as JSample
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.models.codec import api as japi, vocos as jvocos
from tts_max_tpu.training.rlhf import grpo as jgrpo, reward_utils as jru, rewards as jrewards
from tts_max_tpu.training.rlhf.dataset import TtsRLHFDataset as JDataset
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core import tokenization
from tts_max_tpu_torch.core.config import RLHFConfig
from tts_max_tpu_torch.data.audio_io import save_wav
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.inference.generate import generate
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.models.codec import api, vocos
from tts_max_tpu_torch.training import optim
from tts_max_tpu_torch.training.rlhf import grpo, reward_utils as ru, rewards
from tts_max_tpu_torch.training.rlhf.dataset import TtsRLHFDataset

CODEBOOK = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toks():
    jt = jtok.build_byte_tokenizer(codebook_size=CODEBOOK)
    pt = tokenization.build_byte_tokenizer(codebook_size=CODEBOOK)
    return jt, pt, jtok.speech_vocab(jt, CODEBOOK), tokenization.speech_vocab(pt, CODEBOOK)


def _configs(vocab, seq=128):
    jcfg = dataclasses.replace(jllama.tiny_config(vocab_size=vocab, max_seq_len=seq),
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(llama.tiny_config(vocab_size=vocab, max_seq_len=seq),
                               dtype=torch.float32)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def model(toks):
    jcfg, pcfg = _configs(len(toks[1]))
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                      device="cpu")
    return jcfg, pcfg, jparams, params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach().float() if torch.is_tensor(v) else v,
                                             dtype=np.float32)
    return out


def _assert_leaves(got, want, atol=None, rel=1e-4, what=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        if atol is None:
            err = np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-30)
            assert err <= rel, f"{what} {k}: {err:.2e} of max|ref|"
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


# --- reward utils -------------------------------------------------------------

BATTERY = [
    ("Hello, World!  How are you?", "hello world how are you", "en"),
    ("the cat sat", "the cat sat on the mat", "en"),
    ("a b c d e", "e d c b a", "en"),
    ("", "", "en"), ("", "x", "en"), ("x", "", "en"),
    ("你好， 世界。", "你好世界", "zh"), ("日本語のテキスト", "日本のテキスト", "ja"),
    ("한국어 문장", "한국 문장입니다", "ko"),
    ("Ça va? «Oui» — très bien…", "ca va oui tres bien", "fr"),
    ("don't stop", "dont stop", "en"), ("x y " * 20, "x " * 30, "de"),
]


def test_reward_utils_match_jax():
    rng = np.random.default_rng(0)
    for truth, hyp, lang in BATTERY:
        for a, b in ((truth, hyp), (hyp, truth)):
            assert ru.normalize_transcript(a, lang) == jru.normalize_transcript(a, lang)
            assert ru.word_error_rate(a, b) == jru.word_error_rate(a, b)
            assert ru.char_error_rate(a, b) == jru.char_error_rate(a, b)
            assert ru.edit_distance(a.split(), b.split()) == jru.edit_distance(a.split(),
                                                                                b.split())
            assert ru.edit_distance(list(a), list(b)) == jru.edit_distance(list(a), list(b))
        wav = rng.standard_normal(2400).astype(np.float32)
        for sr in (16000, 24000):
            fn = (lambda h: lambda audio, language: h)(hyp)
            assert ru.eval_wer(fn, wav, sr, truth, lang) == jru.eval_wer(fn, wav, sr, truth,
                                                                          lang)
    for _ in range(50):
        a = rng.integers(0, 4, rng.integers(0, 12)).tolist()
        b = rng.integers(0, 4, rng.integers(0, 12)).tolist()
        assert ru.edit_distance(a, b) == jru.edit_distance(a, b)
    for x in (0.0, 0.3, 1.0, 5.0):
        assert ru.normalize_wer(x) == jru.normalize_wer(x)
        assert ru.normalize_dnsmos(x) == jru.normalize_dnsmos(x)
        assert ru.normalize_similarity(x - 1) == jru.normalize_similarity(x - 1)

    def boom(*a):
        raise RuntimeError("backend down")

    wav = rng.standard_normal(1600).astype(np.float32)
    assert ru.eval_wer(boom, wav, 16000, "x", "en") == jru.eval_wer(boom, wav, 16000, "x",
                                                                     "en") == ru.DEFAULT_WER
    assert ru.eval_wer(lambda a, l: "x", np.zeros(0), 16000, "x", "en") == ru.DEFAULT_WER
    emb = lambda a: np.asarray([a.mean(), a.std(), np.abs(a).max()])  # noqa: E731
    p, c = rng.standard_normal(800), rng.standard_normal(1200)
    assert ru.eval_similarity(emb, p, c) == jru.eval_similarity(emb, p, c)
    assert ru.eval_similarity(boom, p, c) == jru.eval_similarity(boom, p, c) == 0.0
    assert ru.eval_similarity(lambda a: np.zeros(3), p, c) == 0.0
    assert ru.eval_similarity(emb, p, np.zeros(0)) == 0.0


# --- dataset ------------------------------------------------------------------


def _sample_dicts(n, wav_paths=None):
    return [{"wav_path": wav_paths[i] if wav_paths else f"w{i}.wav",
             "transcript": f"Text number {i}, spoken!", "language": "en" if i % 2 else "de",
             "duration": 1.0, "sample_rate": 16000} for i in range(n)]


def _datasets(toks, n=3, wav_paths=None, normalizer=None):
    jt, pt, _, _ = toks
    codes = (np.arange(10 * n, dtype=np.int32) * 7) % CODEBOOK
    spans = [(10 * i, 10 * i + 10) for i in range(n)]
    dicts = _sample_dicts(n, wav_paths)
    ds = TtsRLHFDataset("ds", [Sample.from_json(d, "ds") for d in dicts], codes, spans, pt,
                        normalizer)
    jds = JDataset("ds", [JSample.from_json(d, "ds") for d in dicts], codes, spans, jt)
    return ds, jds


def test_dataset_items_match_jax(toks):
    ds, jds = _datasets(toks)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        a, b = ds[i], jds[i]
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["prompt_speech_ids"], b["prompt_speech_ids"])
        for k in ("prompt", "completion_truth", "prompt_wav_path", "language"):
            assert a[k] == b[k], k
    assert ds[0]["completion_truth"] == "Text number 1, spoken!"
    with pytest.raises(ValueError):
        TtsRLHFDataset("ds", [], np.zeros(3, np.int32), [(0, 3)], toks[1])


# --- advantages, logprobs, loss, step -------------------------------------------


def test_advantages_bitwise():
    rng = np.random.default_rng(1)
    for r, g in ((np.array([1.0, 3.0, 2.0, 2.0]), 2), (rng.standard_normal(16), 8),
                 (np.full(8, 0.7), 4), (rng.integers(0, 3, 24).astype(float), 6)):
        for scale in (True, False):
            got = grpo.compute_advantages(r, g, scale)
            want = jgrpo.compute_advantages(r, g, scale)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def _batch(vocab, b=4, L=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, L)).astype(np.int32)
    mask = np.zeros((b, L), bool)
    for i in range(b):
        mask[i, 6 + i: L - i] = True
    adv = rng.standard_normal(b).astype(np.float32)
    return tokens, mask, adv


def test_sequence_logprobs_chunks_match_jax(model):
    jcfg, pcfg, jparams, params = model
    tokens, _, _ = _batch(pcfg.vocab_size, b=3, L=33, seed=2)
    want = np.asarray(jgrpo.sequence_logprobs(jparams, jcfg, jnp.asarray(tokens), chunk_size=0))
    for c in (0, 8, 16, 64):
        got = grpo.sequence_logprobs(params, pcfg, torch.from_numpy(tokens), chunk_size=c)
        assert got.shape == (3, 32)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, err_msg=str(c))


def _port_grads(params, pcfg, tokens, mask, adv, ref, beta):
    leaves = []

    def track(p):
        q = p.detach().requires_grad_(True)
        leaves.append(q)
        return q

    live = optim.tree_map(track, params)
    loss, mean_logp = grpo.grpo_loss(live, torch.from_numpy(tokens), torch.from_numpy(mask),
                                     torch.from_numpy(adv), ref, cfg=pcfg, beta=beta)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return float(loss.detach()), float(mean_logp), optim.tree_map(lambda _: next(it), params)


@pytest.mark.parametrize("beta", [0.0, 0.04])
def test_grpo_loss_and_grads_match_jax(model, beta):
    """Loss and mean logprob within 1e-5, grads within 1e-4 of each leaf's
    largest; the KL term with a reference a step away from the policy."""
    jcfg, pcfg, jparams, params = model
    tokens, mask, adv = _batch(pcfg.vocab_size, seed=3)
    ref_params = optim.tree_map(lambda t: t * 1.01, params)
    jref = jax.tree_util.tree_map(lambda t: t * 1.01, jparams)
    ref = grpo.sequence_logprobs(ref_params, pcfg, torch.from_numpy(tokens)) if beta else None
    jref_lp = jgrpo.sequence_logprobs(jref, jcfg, jnp.asarray(tokens)) if beta else None
    loss, mean_logp, grads = _port_grads(params, pcfg, tokens, mask, adv, ref, beta)
    (jloss, jmean), jgrads = jax.value_and_grad(jgrpo.grpo_loss, has_aux=True)(
        jparams, jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(adv), jref_lp,
        cfg=jcfg, beta=beta)
    np.testing.assert_allclose(loss, float(jloss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean_logp, float(jmean), atol=1e-5, rtol=1e-5)
    _assert_leaves(grads, jgrads, what=f"beta {beta}")
    # all-masked: the denominator is max(mask.sum(), 1)
    zero = np.zeros_like(mask)
    l0, m0, _ = _port_grads(params, pcfg, tokens, zero, adv, ref, beta)
    assert l0 == 0.0 and m0 == 0.0


def test_grpo_step_matches_jax(model):
    """One step (grads past the clip on a hot advantage) with AdamW lr 1e-4
    (the JAX trainer tests' rate), b1 0.9, b2 0.95, wd 0.1 and a bf16 first
    moment. Adam's first update is lr * g / (|g| + 1e-8): a gradient within
    a few 1e-8 of zero, whose last bits differ between the two autodiffs,
    moves it by up to lr, so the rate bounds what 1e-5 can hold."""
    import optax

    jcfg, pcfg, jparams, params = model
    tokens, mask, adv = _batch(pcfg.vocab_size, seed=4)
    adv = adv * 50
    tx = optim.AdamW(1e-4, betas=(0.9, 0.95), weight_decay=0.1, mu_dtype="bf16")
    jtx = optax.adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=jnp.bfloat16)
    step = grpo.make_grpo_step(pcfg, tx, 0.0)
    jstep = jgrpo.make_grpo_step(jcfg, jtx, 0.0)
    p, o, m = step(params, tx.init(params), torch.from_numpy(tokens).long(),
                   torch.from_numpy(mask), torch.from_numpy(adv), None)
    jp, jo, jm = jstep(jparams, jtx.init(jparams), jnp.asarray(tokens), jnp.asarray(mask),
                       jnp.asarray(adv), None)
    assert m.grad_norm > 1.0  # the clip scale applies
    np.testing.assert_allclose([m.loss, m.mean_logp, m.grad_norm],
                               [float(jm.loss), float(jm.mean_logp), float(jm.grad_norm)],
                               rtol=1e-5, atol=1e-5)
    _assert_leaves(p, jp, atol=1e-5, what="params")
    _assert_leaves(o["mu"], jo[0].mu, atol=1e-5, what="mu")
    assert _flat(o["mu"]).keys() and all(
        t.dtype == torch.bfloat16 for t in optim.tree_leaves(o["mu"]))


# --- trainer ------------------------------------------------------------------


class StubReward:
    """A reward that differs inside a group, so advantages are not zero."""

    __name__ = "stub"

    def __call__(self, completions, **kw):
        return [float(len(c) % 5) + 0.5 * (i % 3) for i, c in enumerate(completions)]


def _rlhf_cfg(cls, **kw):
    return cls(num_generations=2, max_completion_length=8, max_prompt_length=64,
               temperature=0.0, **kw)


def _scripted(sv, trainer, torch_side):
    """A stand-in for ``generate``: distinct completions of speech tokens
    with lengths 3-8 per row, drawn from the trainer's step count, the same
    on both sides."""
    import types

    def fn(params, tokens, lengths, key):
        rng = np.random.default_rng(trainer.step)
        b = tokens.shape[0]
        n = rng.integers(3, 9, b).astype(np.int32)
        out = sv.tokens_from_codes(rng.integers(0, CODEBOOK, (b, 8))).astype(np.int32)
        out[np.arange(8)[None] >= n[:, None]] = 0
        if torch_side:
            return types.SimpleNamespace(tokens=torch.from_numpy(out),
                                         num_generated=torch.from_numpy(n), steps=8)
        return types.SimpleNamespace(tokens=jnp.asarray(out), num_generated=jnp.asarray(n))

    return lambda bucket: fn


def _assert_params(got, want, grads, lr, noisy, what):
    """Params within 1e-5 of JAX's, but where a step's gradient so far was
    within 1e-6 of its leaf's largest (``noisy`` collects them): there the
    two autodiffs' last bits may differ in sign, and Adam divides a gradient
    by its own magnitude (lr * g / (|g| + 1e-8)), so that update may take
    either sign; the params there are held to 2 lr a step. Such elements are
    under 1% of all (about 0.2% over the two steps)."""
    g, w, gr = _flat(got), _flat(want), _flat(grads)
    held = total = 0
    for k in w:
        noise = noisy[k] = noisy.get(k, False) | (np.abs(gr[k]) <= 1e-6 * np.abs(gr[k]).max())
        err = np.abs(g[k] - w[k])
        assert err[~noise].max(initial=0) <= 1e-5, (what, k, err[~noise].max())
        assert err.max() <= 4 * lr + 1e-6, (what, k, err.max())
        held, total = held + (~noise).sum(), total + noise.size
    assert held > 0.99 * total, (what, held, total)


@pytest.mark.parametrize("sampler", ["greedy", "scripted"])
def test_two_trainer_steps_match_jax(toks, model, sampler):
    """Two ``train_step``s on each side: the rollouts (prompt + completion
    ids, masks), advantages, stats, loss, mean logprob and grad norm equal
    or within 1e-5, each step's gradient within 1e-4 of each leaf's largest,
    and the params within 1e-5.

    Greedy rollouts give a group's rows the same completion, so their
    advantages (which sum to zero in a group) cancel and the gradient is
    rounding noise, which Adam's first steps scale up to the learning rate:
    the gradients, the second step's loss and the params are held to JAX's
    with ``scripted`` rollouts, distinct completions handed to both
    trainers in place of ``generate`` (``_assert_params``: 1e-5, and 2 lr
    at the under 1% of elements whose gradient is within 1e-6 of its
    leaf's largest); the greedy run holds the rollout ids of both steps and
    the first step's numbers."""
    jt, pt, jsv, sv = toks
    jcfg, pcfg, jparams, params = model
    ds, jds = _datasets(toks)
    trainer = grpo.GRPOTrainer(params, pcfg, pt, sv, [StubReward()], _rlhf_cfg(RLHFConfig),
                               learning_rate=1e-4)
    jtrainer = jgrpo.GRPOTrainer(jparams, jcfg, jt, jsv, [StubReward()],
                                 _rlhf_cfg(JRLHFConfig), learning_rate=1e-4)
    if sampler == "scripted":
        trainer._generate_fn = _scripted(sv, trainer, True)
        jtrainer._generate_fn = _scripted(jsv, jtrainer, False)
    noisy = {}
    for prompts in ([0, 1], [1, 2]):
        before = trainer.params  # the step leaves it as it was
        stats = trainer.train_step([ds[i] for i in prompts])
        batch = trainer.last_batch
        jbatch, _ = jtrainer.rollout([jds[i] for i in prompts])
        jgrads = jax.grad(lambda p: jgrpo.grpo_loss(
            p, jnp.asarray(jbatch.tokens), jnp.asarray(jbatch.completion_mask),
            jnp.asarray(jbatch.advantages), None, cfg=jcfg)[0])(jtrainer.params)
        jstats = jtrainer.train_step([jds[i] for i in prompts])
        np.testing.assert_array_equal(batch.tokens, jbatch.tokens)
        np.testing.assert_array_equal(batch.completion_mask, jbatch.completion_mask)
        np.testing.assert_array_equal(batch.advantages, jbatch.advantages)
        assert np.abs(batch.advantages).max() > 0
        for k in ("reward_mean", "reward_std", "completion_len", "stub", "step"):
            assert stats[k] == jstats[k], k
        if sampler == "greedy" and stats["step"] == 2:
            continue  # the noise step 1 took moved the params apart (see above)
        for k in ("loss", "mean_logp", "grad_norm"):
            np.testing.assert_allclose(stats[k], jstats[k], atol=1e-5, rtol=1e-5, err_msg=k)
        if sampler == "scripted":
            assert stats["grad_norm"] > 1e-3
            _, _, grads = _port_grads(before, pcfg, batch.tokens, batch.completion_mask,
                                      batch.advantages, None, 0.0)
            _assert_leaves(grads, jgrads, what=f"step {stats['step']} grads")
            _assert_params(trainer.params, jtrainer.params, jgrads, 1e-4, noisy,
                           what=f"step {stats['step']}")
    assert trainer.rollout_params is not trainer.params  # sampled from the step-1 weights


def test_engine_rollout_sees_updated_weights(toks, model):
    """After a GRPO step, a greedy rollout through the engine equals
    ``generate`` with the updated params (and differs from ``generate``
    with the first ones): the engine's params and vocab-window head are the
    trainer's new ones."""
    _, pt, _, sv = toks
    _, pcfg, _, params = model
    ds, _ = _datasets(toks)
    cfg = _rlhf_cfg(RLHFConfig, constrain_to_speech=True)
    trainer = grpo.GRPOTrainer(params, pcfg, pt, sv, [StubReward()], cfg,
                               learning_rate=3e-2, rollout_via_engine=True)
    trainer.train_step([ds[0], ds[1]])
    eng = trainer._engine
    assert eng.params is trainer.params and trainer.rollout_params is not trainer.params
    batch, _ = trainer.rollout([ds[0], ds[2]])
    assert eng.params is trainer.params
    torch.testing.assert_close(
        eng._head, llama.slice_logits_head(trainer.params, pcfg, *sv.generation_window()),
        rtol=0, atol=0)

    def gen(p):
        enc = [np.asarray(pt.encode(ds[i]["prompt"], add_special_tokens=True),
                          np.int32)[:cfg.max_prompt_length] for i in (0, 2)]
        bucket = -(-max(map(len, enc)) // 64) * 64
        toks_ = np.zeros((4, bucket), np.int32)
        lens = np.zeros(4, np.int32)
        for r in range(4):
            e = enc[r // 2]
            toks_[r, :len(e)], lens[r] = e, len(e)
        res = generate(p, pcfg, toks_, lens, None, sp=trainer._sp, max_new_tokens=8,
                       eos_id=sv.speech_end_id, vocab_window=sv.generation_window(),
                       device="cpu")
        return res.tokens.numpy(), res.num_generated.numpy(), lens

    got = batch.tokens
    new, n_new, lens = gen(trainer.params)
    old, _, _ = gen(params)
    for r in range(4):
        np.testing.assert_array_equal(got[r, lens[r]:lens[r] + n_new[r]], new[r, :n_new[r]])
        assert not batch.completion_mask[r, lens[r] + n_new[r]:].any()
    assert not np.array_equal(new, old), "the step did not change the greedy rollout"


# --- rewards ------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoders():
    cfg = vocos.tiny_vocos_config()
    params = vocos.init_decoder(cfg, seed=3, device="cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params,
                                     is_leaf=lambda t: isinstance(t, torch.Tensor))
    jcfg = jvocos.tiny_vocos_config()
    return (api.AudioDecoder(params, cfg, api.DecoderConfig(), device="cpu"),
            japi.AudioDecoder(jparams, jcfg, japi.DecoderConfig()))


def _stub_backends():
    def transcribe(audio, language):
        return "text number" if float(np.mean(audio)) > 0 else "text number one spoken"

    def dnsmos_fn(audio, sr):
        return 1.0 + 4.0 / (1.0 + np.exp(-50.0 * float(np.std(audio))))

    def embed(audio):
        a = np.asarray(audio, np.float64)
        return np.asarray([a.mean(), a.std(), np.abs(a).max(), (a[:100] ** 2).sum()])

    return {"transcribe_fn": transcribe, "dnsmos_fn": dnsmos_fn, "embed_fn": embed}


@pytest.mark.parametrize("spectral", [False, True])
def test_reward_classes_match_jax(toks, decoders, tmp_path, spectral):
    """WER, DNSMOS and similarity rewards (and the similarity's spectral
    fallback without an ``embed_fn``) within 1e-5 of JAX's, on token-id and
    string completions, an empty one and a missing prompt wav; only the
    first function saves wavs."""
    jt, pt, jsv, sv = toks
    dec, jdec = decoders
    paths = []
    for i in range(2):
        p = str(tmp_path / f"p{i}.wav")
        save_wav(p, (np.sin(np.arange(8000) / (9 + i)) * 0.3).astype(np.float32), 16000)
        paths.append(p)
    backends = _stub_backends()
    if spectral:
        backends.pop("embed_fn")
    names = ["wer", "dnsmos", "similarity"]
    funcs = rewards.create_reward_funcs(names, dec, sv, save_completions_steps=1,
                                        save_dir=str(tmp_path / "ours"), backends=backends)
    jfuncs = jrewards.create_reward_funcs(names, jdec, jsv, save_completions_steps=1,
                                          save_dir=str(tmp_path / "jax"), backends=backends)
    rng = np.random.default_rng(5)
    completions = [sv.tokens_from_codes(rng.integers(0, CODEBOOK, 12)),
                   sv.tokens_from_codes(rng.integers(0, CODEBOOK, 20)),
                   np.zeros(0, np.int64), "<|s_3|><|s_9|><|s_27|>"]
    kw = {"prompt_speech_ids": [rng.integers(0, CODEBOOK, 6) for _ in range(4)],
          "completion_truth": ["text number one", "Text number", "x", "text number one"],
          "language": ["en", "en", "de", "en"],
          "prompt_wav_path": [paths[0], paths[1], paths[0], str(tmp_path / "missing.wav")]}
    for f, jf in zip(funcs, jfuncs):
        got, want = f(completions, **kw), jf(completions, **kw)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=f.__name__)
    import os

    assert len(os.listdir(tmp_path / "ours")) == 3  # the non-empty completions, first func
    assert not any(f._save_dir for f in funcs[1:])
    # a tone in noise (a pure tone leaves bands at the FFT's rounding floor,
    # whose logs differ between any two FFT libraries)
    x = (np.sin(np.arange(4000) / 7.0) + 0.1 * rng.standard_normal(4000)).astype(np.float32)
    fb = rewards.spectral_embed_fn(x, "cpu")
    jfb = jrewards.spectral_embed_fn(x)
    np.testing.assert_allclose(fb, jfb, atol=1e-5, rtol=1e-5)
