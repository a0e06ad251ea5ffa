"""The port's data tools, ``tts_max_tpu_torch.tools.data_vectorizer`` and
``data_merger``, against the JAX package's ``tools/data_vectorizer.py`` and
``tools/data_merger.py`` on the samples ``example/make_synthetic_samples.py``
writes: the same codes from ``encode_samples`` on the same tiny encoder
weights (the port's seeded weights handed to a JAX ``api.AudioEncoder`` as
numpy), shard and merged files byte-identical to the JAX tools', and the
port's vectorizer and merger end to end on the CPU."""

import filecmp
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.data import codes_io as jcodes
from tts_max_tpu.data import samples as jsamples
from tts_max_tpu.models.codec import api as japi
from tts_max_tpu.models.codec import encoder as jenc
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.data import codes_io, samples as tsamples
from tts_max_tpu_torch.models.codec import api as tapi
from tts_max_tpu_torch.models.codec import encoder as tenc
from tts_max_tpu_torch.tools import data_merger, data_vectorizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """10 samples of 0.5-3 s from the example script."""
    out = str(tmp_path_factory.mktemp("samples"))
    subprocess.run([sys.executable, os.path.join(ROOT, "example", "make_synthetic_samples.py"),
                    "--output_dir", out, "--n", "10"], check=True, capture_output=True)
    return os.path.join(out, "samples.jsonl")


@pytest.fixture(scope="module")
def encoders():
    """The tiny encoder of both packages on the port's seeded weights, the
    conv kernels x10 and the SnakeBeta parameters random so that the codes
    vary; both with an all-zero semantic stream, as the tools' smoke mode."""
    cfg = tenc.tiny_encoder_config()
    rng = np.random.default_rng(3)

    def livelier(path, x):
        if path[-1].key in ("alpha", "beta"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        return x * 10 if path[-1].key == "kernel" and x.ndim == 3 else x

    ep = jax.tree_util.tree_map_with_path(
        livelier, jax.tree_util.tree_map(lambda t: t.numpy(),
                                         tenc.init_encoder(cfg, seed=0, device="cpu")))
    jcfg = jenc.tiny_encoder_config()

    def jzero(wav):
        return jnp.zeros((wav.shape[0], wav.shape[1] // jcfg.hop_length,
                          jcfg.semantic_input_dim))

    def tzero(wav):
        return torch.zeros(wav.shape[0], wav.shape[1] // cfg.hop_length,
                           cfg.semantic_input_dim)

    jencoder = japi.AudioEncoder(jax.tree_util.tree_map(jnp.asarray, ep), jcfg, jzero)
    tencoder = tapi.AudioEncoder(convert.encoder_from_numpy(ep, cfg, device="cpu"), cfg,
                                 tzero, device="cpu")
    return jencoder, tencoder


def _jax_tool(name):
    sys.path.insert(0, ROOT)
    try:
        return __import__(f"tools.{name}", fromlist=[name])
    finally:
        sys.path.remove(ROOT)


def test_encode_samples_codes_equal_jax(synthetic, encoders):
    jencoder, tencoder = encoders
    jvec = _jax_tool("data_vectorizer")
    js = jsamples.read_samples_jsonl(synthetic, "ds")
    ts = tsamples.read_samples_jsonl(synthetic, "ds")
    jcodes_, jindex, jkept = jvec.encode_samples(jencoder, js, types.SimpleNamespace(
        batch_size=4))
    tcodes, tindex, tkept = data_vectorizer.encode_samples(tencoder, ts, batch_size=4)
    assert len(np.unique(tcodes)) > 5  # the codes vary
    np.testing.assert_array_equal(tcodes, jcodes_)
    np.testing.assert_array_equal(tindex, jindex)
    assert tcodes.dtype == np.int32 and tindex.dtype == np.int64
    assert [s.wav_path for s in tkept] == [s.wav_path for s in jkept] \
        == [s.wav_path for s in ts]


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_shard_and_merged_files_equal_jax_tools(synthetic, encoders, tmp_path):
    """Two ranks' shards written by both packages' ``write_shard`` from the
    same codes are byte-identical; so are the files each package's merger
    makes of them."""
    _, tencoder = encoders
    ts = tsamples.read_samples_jsonl(synthetic, "ds")
    # a jsonl without ids gets a random uuid per read: JAX's samples take the
    # port's, so the ids agree
    js = {s.wav_path: jsamples.Sample.from_json(s.to_json(), "ds") for s in ts}
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    for rank in (0, 1):
        mine = codes_io.chunk_work(ts, rank, 2)
        assert [s.wav_path for s in mine] == [
            s.wav_path for s in jcodes.chunk_work(list(js.values()), rank, 2)]
        for split, part in (("train", mine[1:]), ("val", mine[:1])):
            codes, index, kept = data_vectorizer.encode_samples(tencoder, part, batch_size=4)
            codes_io.write_shard(tdir, split, codes, index, kept, rank=rank)
            jcodes.write_shard(jdir, split, codes, index, [js[s.wav_path] for s in kept],
                               rank=rank)
    _same_files(tdir, jdir)
    merged = data_merger.main(["--dataset_dir", tdir, "--remove_shards"])
    _jax_tool("data_merger").main(["--dataset_dir", jdir, "--remove_shards"])
    assert set(merged) == {"train", "val"} and merged["train"]["num_shards"] == 2
    _same_files(tdir, jdir)
    assert sorted(os.listdir(tdir)) == sorted(
        os.path.basename(p) for split in ("train", "val") for p in codes_io.codes_paths(
            tdir, split))


def test_vectorizer_and_merger_end_to_end(synthetic, tmp_path):
    """``python -m tts_max_tpu_torch.tools.data_vectorizer --tiny --device
    cpu`` as two processes, then ``data_merger``: the merged dataset loads
    through ``codes_io`` with every sample and its own code count (one code
    per 320 samples of the hop-padded wav)."""
    out = str(tmp_path / "ds")
    written = [data_vectorizer.main(["--samples_path", synthetic, "--output_dir", out,
                                     "--tiny", "--device", "cpu", "--batch_size", "4",
                                     "--val_ratio", "0.25", "--process_index", str(r),
                                     "--process_count", "2"]) for r in (0, 1)]
    assert all(set(w) == {"train", "val"} for w in written)
    data_merger.main(["--dataset_dir", out])
    n = 0
    for split in ("train", "val"):
        codes, samples, spans, status = codes_io.load_and_filter_audio_codes_and_samples(
            out, split)
        assert len(samples) == sum(w[split][0] for w in written)
        assert spans[-1][1] == len(codes) == sum(w[split][1] for w in written)
        for s, (a, b) in zip(samples, spans):
            assert b - a == round(s.duration * 16000) // 320 + 1
        n += len(samples)
    assert n == 10
    shutil.rmtree(out)
