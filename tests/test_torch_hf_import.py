"""The port's HF checkpoint import/export and its own safetensors reader and
writer, against the JAX package's ``hf_import`` and the ``safetensors``
package of this machine (the card's machine has neither; the port uses
neither).

A tiny model is exported by JAX's ``save_model_to_hf_dir``; the port's
``load_model_from_hf_dir`` must give parameters bitwise equal to JAX's
import of the same directory, and fp32 logits within 1e-5 of JAX's."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from tts_max_tpu.models import hf_import as jhf
from tts_max_tpu.models import llama as jl
from tts_max_tpu_torch.models import hf_import as thf
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models import safetensors_io


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_bitwise(ours, ref):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(ours) == sorted(ref)
    for name, a in ours.items():
        b = np.asarray(ref[name])
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def exported(request, tmp_path_factory):
    """A tiny fp32 model exported by the JAX package (GQA, llama3 rope
    scaling on, tied or untied head)."""
    cfg = dataclasses.replace(jl.tiny_config(vocab_size=96, max_seq_len=64),
                              dtype=jnp.float32, tie_embeddings=request.param,
                              use_llama3_rope_scaling=True)
    params = jl.init_params(jax.random.PRNGKey(3), cfg)
    d = str(tmp_path_factory.mktemp("hf"))
    jhf.save_model_to_hf_dir(params, cfg, d, eos_token_id=7)
    return d, cfg


def test_load_matches_jax_bitwise_and_logits(exported):
    d, jcfg = exported
    ref, rcfg = jhf.load_model_from_hf_dir(d)
    ours, cfg = thf.load_model_from_hf_dir(d, device="cpu", dtype=torch.float32)
    assert (cfg.vocab_size, cfg.dim, cfg.n_layers, cfg.n_kv_heads, cfg.tie_embeddings,
            cfg.use_llama3_rope_scaling, cfg.rope_theta) == (
        rcfg.vocab_size, rcfg.dim, rcfg.n_layers, rcfg.n_kv_heads, rcfg.tie_embeddings,
        rcfg.use_llama3_rope_scaling, rcfg.rope_theta)
    _assert_bitwise(ours, ref)
    tokens = np.random.default_rng(0).integers(0, 96, (2, 11)).astype(np.int32)
    want = jl.forward(jax.tree_util.tree_map(jnp.asarray, ref),
                      dataclasses.replace(rcfg, dtype=jnp.float32), jnp.asarray(tokens))
    got = tl.forward(ours, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the default compute dtype is bf16, as in JAX: kernels and the
    # embedding in bf16, norm scales in fp32
    bf, bcfg = thf.load_model_from_hf_dir(d, device="cpu")
    assert bcfg.dtype == torch.bfloat16
    assert bf["layers"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert bf["norm"]["scale"].dtype == torch.float32


def test_port_export_round_trips_through_both_loaders(exported, tmp_path):
    """The port's fp32 export reads back bitwise through JAX's loader and its
    own; its bf16 export (as a real HF checkpoint stores the weights) reads
    back as the bf16 rounding of every tensor."""
    d, _ = exported
    params, cfg = thf.load_model_from_hf_dir(d, device="cpu", dtype=torch.float32)
    out = str(tmp_path / "fp32")
    thf.save_model_to_hf_dir(params, cfg, out, eos_token_id=9)
    _assert_bitwise(thf.load_model_from_hf_dir(out, device="cpu", dtype=torch.float32)[0],
                    params)
    _assert_bitwise(params, jhf.load_model_from_hf_dir(out)[0])
    with open(os.path.join(out, "config.json")) as f:
        conf = json.load(f)
    assert conf["eos_token_id"] == 9 and conf["torch_dtype"] == "float32"
    out16 = str(tmp_path / "bf16")
    thf.save_model_to_hf_dir(params, cfg, out16, dtype=torch.bfloat16)
    header, meta, _ = safetensors_io.read_header(os.path.join(out16, "model.safetensors"))
    assert {e["dtype"] for e in header.values()} == {"BF16"} and meta == {"format": "pt"}
    got, _ = thf.load_model_from_hf_dir(out16, device="cpu", dtype=torch.float32)
    rounded = {k: v.bfloat16().float() for k, v in _leaves(params)}
    for name, t in _leaves(got):
        assert torch.equal(t, rounded[name]), name


def test_writer_is_read_back_bitwise_by_the_safetensors_package(tmp_path):
    """F32, BF16, a transposed (non-contiguous) view, and the integer and
    F16 types; and the port's reader reads the package's own files."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(5, 7, generator=g)
    tensors = {
        "f32": torch.randn(3, 4, generator=g),
        "bf16": torch.randn(6, 2, generator=g).bfloat16(),
        "transposed": base.T,
        "transposed_bf16": base.bfloat16().T,
        "f16": torch.randn(9, generator=g).half(),
        "i8": torch.randint(-128, 127, (4, 4), dtype=torch.int8, generator=g),
        "u8": torch.randint(0, 255, (3,), dtype=torch.uint8, generator=g),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 3), dtype=torch.int32, generator=g),
        "i64": torch.randint(-2 ** 62, 2 ** 62, (5,), dtype=torch.int64, generator=g),
        "scalar": torch.tensor(1.5),
    }
    path = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    back = st_load_torch(path)
    assert sorted(back) == sorted(tensors)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    theirs = str(tmp_path / "theirs.safetensors")
    st_save_torch({k: v.contiguous() for k, v in tensors.items()}, theirs,
                  metadata={"format": "pt"})
    mine = safetensors_io.load_file(theirs)
    for name, t in tensors.items():
        assert mine[name].dtype == t.dtype and torch.equal(mine[name], t), name
    assert safetensors_io.read_header(path)[1] == {"format": "pt", "note": "x"}


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("new_vocab", [130, 60])
def test_resize_embeddings_bitwise_equal_to_jax(tied, new_vocab):
    cfg = dataclasses.replace(jl.tiny_config(vocab_size=96), dtype=jnp.float32,
                              tie_embeddings=tied)
    jp = jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(4), cfg))
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=96), dtype=torch.float32,
                               tie_embeddings=tied)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    # JAX holds an imported lm_head as the transpose of HF's array
    ref_in = dict(jp)
    if not tied:
        ref_in["lm_head"] = {"kernel": np.ascontiguousarray(jp["lm_head"]["kernel"].T).T}
    ref, rcfg = jhf.resize_embeddings(ref_in, cfg, new_vocab, seed=5)
    ours, ocfg = thf.resize_embeddings(tp, tcfg, new_vocab, seed=5)
    assert ocfg.vocab_size == rcfg.vocab_size == new_vocab
    np.testing.assert_array_equal(ours["embed"]["embedding"].numpy(),
                                  ref["embed"]["embedding"])
    if not tied:
        np.testing.assert_array_equal(ours["lm_head"]["kernel"].numpy(),
                                      ref["lm_head"]["kernel"])


def test_load_with_vocab_resize_matches_jax(exported):
    d, _ = exported
    ref, rcfg = jhf.load_model_from_hf_dir(d, vocab_size=120)
    ours, cfg = thf.load_model_from_hf_dir(d, vocab_size=120, device="cpu",
                                           dtype=torch.float32)
    assert cfg.vocab_size == rcfg.vocab_size == 120 and cfg.dtype == torch.float32
    _assert_bitwise(ours, ref)


def test_two_shards_and_a_bin_dir_load(exported, tmp_path):
    """The state dict split over two safetensors shards (read in sorted
    order), and the same as ``.bin`` shards through ``torch.load``."""
    d, _ = exported
    want, _ = thf.load_model_from_hf_dir(d, device="cpu", dtype=torch.float32)
    sd = safetensors_io.load_file(os.path.join(d, "model.safetensors"))
    names = sorted(sd)
    halves = names[: len(names) // 2], names[len(names) // 2:]
    shards, bins = tmp_path / "shards", tmp_path / "bins"
    for out in (shards, bins):
        out.mkdir()
        with open(os.path.join(d, "config.json")) as f, open(out / "config.json", "w") as g:
            g.write(f.read())
    for i, part in enumerate(halves):
        st_save_numpy({k: sd[k].numpy() for k in part},
                      str(shards / f"model-{i + 1:05d}-of-00002.safetensors"))
        torch.save({k: sd[k] for k in part}, bins / f"pytorch_model-{i + 1:05d}-of-00002.bin")
    (shards / "model.safetensors.index.json").write_text("{}")
    for out in (shards, bins):
        got, _ = thf.load_model_from_hf_dir(str(out), device="cpu", dtype=torch.float32)
        for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b), (out.name, name)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        thf._load_hf_state_dict(str(empty))
