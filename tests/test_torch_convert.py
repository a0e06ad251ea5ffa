"""The port's ``tts_max_tpu_torch.tools.convert_checkpoint`` against the JAX
package's ``tools/convert_checkpoint.py``: the same numpy weights saved as
the port's final model and as JAX's (``save_final_model``), one shared LoRA
adapter file, ``--add_nonverbal`` and ``--quantize``. Every tensor of the two
HF dirs and of the two quantized dirs is bitwise equal and the configs are
equal, with ``test_torch_quant.py``'s bar for the quantized scales (one fp32
ulp, two for int4: XLA's jitted quantization multiplies by a reciprocal
where the port divides), and the levels within one step of JAX's, bitwise
but for at most 1e-5 of them (a weight at a rounding tie under a scale one
ulp apart). Where the LoRA product a@b rounds differently (torch's and
XLA's fp32 sums of r products), the merged kernels are held to one bf16 ulp
and, where such a kernel is quantized, its levels to one step and its
scales to one bf16 ulp; the test counts such elements. With
``--vocab_size 193856`` the nonverbal resize cuts the vocab to 65856 rows in
both tools (ROADMAP.md section 3)."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.models import llama as jllama
from tts_max_tpu.models import lora as jlora
from tts_max_tpu.training import checkpointing as jckpt
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer
from tts_max_tpu_torch.models import hf_import, llama, lora, safetensors_io
from tts_max_tpu_torch.tools import convert_checkpoint
from tts_max_tpu_torch.training import checkpointing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, ALPHA = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_convert():
    sys.path.insert(0, ROOT)
    try:
        from tools import convert_checkpoint as jconvert
    finally:
        sys.path.remove(ROOT)
    return jconvert


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _tensors(path):
    return {k: v.numpy() for k, v in safetensors_io.load_file(path).items()}


# int4 in 64-row groups: the tiny model's 64-wide rows hold no 128-row group
@pytest.mark.parametrize("vocab,mode", [(0, "int8"), (193856, "int4-g64")])
def test_convert_matches_jax_tool(tmp_path, vocab, mode):
    n_vocab = vocab or len(build_byte_tokenizer())
    jcfg = jllama.config_for_architecture("llama-tiny", vocab_size=n_vocab)
    jparams = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    numpy_params = jax.tree_util.tree_map(np.asarray, jparams)
    pcfg = dataclasses.replace(llama.config_for_architecture("llama-tiny",
                                                             vocab_size=n_vocab),
                               dtype=torch.float32)
    pparams = convert.llama_from_numpy(numpy_params, pcfg, device="cpu")
    jout, pout = str(tmp_path / "jax_train"), str(tmp_path / "port_train")
    jckpt.save_final_model(jout, jparams)
    checkpointing.save_final_model(pout, pparams)

    # one adapter file for both tools, non-zero a and b
    rng = np.random.default_rng(5)
    template = jlora.init_lora(jax.random.PRNGKey(0), jparams, r=R)
    adapter = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05),
        template)
    adapter_path = str(tmp_path / "adapter.npz")
    jlora.save_adapter(adapter_path, adapter)

    common = ["--architecture", "llama-tiny", "--add_nonverbal", "--lora_adapter",
              adapter_path, "--lora_r", str(R), "--lora_alpha", str(ALPHA),
              "--quantize", mode] + (["--vocab_size", str(vocab)] if vocab else [])
    jdir, pdir = str(tmp_path / "jax_hf"), str(tmp_path / "port_hf")
    _jax_convert().main(["--checkpoint_dir", jout, "--output_dir", jdir] + common)
    merged, cfg = convert_checkpoint.main(["--checkpoint_dir", pout, "--output_dir", pdir,
                                           "--device", "cpu"] + common)

    with open(os.path.join(jdir, "config.json")) as f:
        jconf = json.load(f)
    with open(os.path.join(pdir, "config.json")) as f:
        pconf = json.load(f)
    assert pconf == jconf
    tok = build_byte_tokenizer()
    assert pconf["eos_token_id"] == tok.convert_tokens_to_ids("<|speech_end|>")
    # the nonverbal resize sets the vocab whatever it was: it grows the byte
    # tokenizer's 65806 and cuts the fixed 193856 to the same 65856
    assert pconf["vocab_size"] == cfg.vocab_size == 65856

    jt, pt = _tensors(os.path.join(jdir, "model.safetensors")), \
        _tensors(os.path.join(pdir, "model.safetensors"))
    assert pt.keys() == jt.keys()
    n_ulp = 0
    for k in jt:
        assert pt[k].dtype == jt[k].dtype == np.float32, k
        if k.endswith("_proj.weight") and ".layers." in k:
            # a LoRA-merged kernel: XLA's and torch's fp32 a@b may round apart
            diff = np.abs(pt[k] - jt[k])
            assert (diff <= _bf16_ulp(jt[k])).all(), k
            n_ulp += int((diff > 0).sum())
        else:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)

    qj = os.path.join(jdir, f"quantized-{mode}")
    qp = os.path.join(pdir, f"quantized-{mode}")
    for name in ("quantized_config.json",):
        with open(os.path.join(qj, name)) as a, open(os.path.join(qp, name)) as b:
            assert json.load(a) == json.load(b)
    qjt = _tensors(os.path.join(qj, "model.quant.safetensors"))
    qpt = _tensors(os.path.join(qp, "model.quant.safetensors"))
    assert qpt.keys() == qjt.keys()
    for k in qjt:
        assert qpt[k].dtype == qjt[k].dtype, k
        merged_kernel = n_ulp and k.startswith("layers/") and "norm" not in k
        if k.endswith(("/q", "/q4")):
            a, b = qpt[k], qjt[k]
            if k.endswith("/q4"):  # nibble pairs
                a, b = np.stack([a & 15, a >> 4]), np.stack([b & 15, b >> 4])
            step = np.abs(a.astype(np.int16) - b.astype(np.int16))
            # a scale one fp32 ulp apart moves a weight at a rounding tie by
            # one level: within one step, and bitwise almost everywhere
            assert step.max() <= 1, k
            assert merged_kernel or (step > 0).mean() <= 1e-5, (k, int((step > 0).sum()))
        elif k.endswith("/scale") and "norm" not in k:
            if merged_kernel:
                assert (np.abs(qpt[k] - qjt[k]) <= _bf16_ulp(qjt[k])).all(), k
            else:  # test_torch_quant.py's bar: XLA's jitted scales take a reciprocal
                np.testing.assert_array_max_ulp(qpt[k], qjt[k],
                                                maxulp=1 if mode == "int8" else 2)
        else:
            np.testing.assert_array_equal(qpt[k], qjt[k], err_msg=k)

    # the returned merged weights are what the HF dir holds, and a reload
    # through the port's loader gives them back
    loaded, lcfg = hf_import.load_model_from_hf_dir(pdir, device="cpu", dtype=torch.float32)
    assert lcfg.vocab_size == 65856
    assert torch.equal(loaded["layers"]["mlp"]["w_up"]["kernel"],
                       merged["layers"]["mlp"]["w_up"]["kernel"])
    base = convert.llama_from_numpy(numpy_params, pcfg, device="cpu")
    want = lora.merge(base, lora.load_adapter(adapter_path, lora.init_lora(base, r=R)),
                      ALPHA, R)
    assert torch.equal(merged["layers"]["attn"]["wq"]["kernel"],
                       want["layers"]["attn"]["wq"]["kernel"])
