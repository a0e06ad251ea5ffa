"""The port's data plane (``tts_max_tpu_torch/core/config.py``,
``core/prompting.py``, ``data/``) against the JAX package's, mirroring
``tests/test_data.py``: the same inputs through both give equal configs,
prompts, byte-identical ``codes_io`` files, equal filtered spans, dataset
items, batches and loader orders (all exact: the modules are numpy)."""

import os

import numpy as np
import pytest

from tts_max_tpu.core import config as jconfig
from tts_max_tpu.core import prompting as jprompting
from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu.data import codes_io as jcodes_io
from tts_max_tpu.data import collate as jcollate
from tts_max_tpu.data import datasets as jdatasets
from tts_max_tpu.data import filtering as jfiltering
from tts_max_tpu.data import loader as jloader
from tts_max_tpu.data.normalization import BasicTextNormalizer as JNormalizer
from tts_max_tpu.data.samples import Sample as JSample
from tts_max_tpu_torch.core import config, prompting, tokenization
from tts_max_tpu_torch.data import builder, codes_io, collate, datasets, filtering, loader
from tts_max_tpu_torch.data.normalization import BasicTextNormalizer
from tts_max_tpu_torch.data.samples import Sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toks():
    return jtok.build_byte_tokenizer(codebook_size=65536), tokenization.build_byte_tokenizer(
        codebook_size=65536)


def _sample_dicts(n):
    return [{"id": f"sample-{i}", "wav_path": f"w{i}.wav",
             "transcript": f"Hello world {i}, it's 3 o'clock!",
             "language": "en" if i % 3 else "de", "duration": 2.0 + i, "sample_rate": 16000,
             "voice_description": "a calm voice" if i == 2 else ""} for i in range(n)]


def test_sft_config_equals_jax():
    path = os.path.join(ROOT, "example", "configs", "sft.json")
    ours = config.ExperimentConfig.from_json(path)
    theirs = jconfig.ExperimentConfig.from_json(path)
    assert config.to_dict(ours) == jconfig.to_dict(theirs)
    assert ours.training.loss_chunk_size == 256 and ours.training.adam_mu_dtype == "bf16"
    default = config.to_dict(config.ExperimentConfig())
    assert default == jconfig.to_dict(jconfig.ExperimentConfig())
    assert default["training"]["adam_mu_dtype"] == "fp32"


@pytest.mark.parametrize("transcript,ids,desc", [("hello", [3, 7], ""),
                                                 ("hi there", [1], "a deep voice"),
                                                 ("x", list(range(40)), "")])
def test_compile_training_prompt_matches(transcript, ids, desc):
    assert (prompting.compile_training_prompt(transcript, ids, desc)
            == jprompting.compile_training_prompt(transcript, ids, desc))
    with pytest.raises(ValueError):
        prompting.compile_training_prompt("x", [])


def _write_both(tmp_path, split, shards):
    """The same shards through both packages' write_shard (and merge)."""
    dirs = []
    for name, cio, sample_cls in (("jax", jcodes_io, JSample), ("port", codes_io, Sample)):
        d = str(tmp_path / name)
        for rank, (codes, index, samples) in enumerate(shards):
            cio.write_shard(d, split, codes, index,
                            [sample_cls.from_json(s, "ds") for s in samples],
                            rank=rank if len(shards) > 1 else None)
        if len(shards) > 1:
            info = cio.merge_shards(d, split)
            cio.validate_merged(d, split)
            assert info["num_shards"] == len(shards)
        dirs.append(d)
    return dirs


def test_codes_io_files_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    shards = [(rng.integers(0, 65536, 10).astype(np.int32), np.array([0, 4, 7]),
               _sample_dicts(3)),
              (rng.integers(0, 65536, 6).astype(np.int32), np.array([0, 2]),
               _sample_dicts(2))]
    jdir, pdir = _write_both(tmp_path, "train", shards)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) and "train_codes.npy" in names
    for n in names:
        with open(os.path.join(jdir, n), "rb") as a, open(os.path.join(pdir, n), "rb") as b:
            assert a.read() == b.read(), n
    assert os.path.getsize(os.path.join(pdir, "train_codes_0.npy")) == 10 * 4  # headerless


def test_filtering_and_finetuning_dataset_match(tmp_path, toks):
    jtk, tk = toks
    samples = _sample_dicts(6)
    samples[1]["transcript"] = ""
    samples[1]["voice_description"] = "desc"  # a valid Sample, filtered
    samples[4]["duration"] = 31.0  # over the 30 s limit
    lens = [30, 25, 40, 12, 33, 20]
    codes = np.random.default_rng(1).integers(0, 65536, sum(lens)).astype(np.int32)
    index = np.concatenate([[0], np.cumsum(lens)[:-1]])
    jdir, pdir = _write_both(tmp_path, "val", [(codes, index, samples)])
    jcfg = jconfig.DatasetConfig(allowed_languages=("en", "de"))
    pcfg = config.DatasetConfig(allowed_languages=("en", "de"))
    jc, jkept, jspans, jstatus = jcodes_io.load_and_filter_audio_codes_and_samples(
        jdir, "val", jcfg, extra_filters=[jfiltering.filter_empty_transcript])
    c, kept, spans, status = codes_io.load_and_filter_audio_codes_and_samples(
        pdir, "val", pcfg, extra_filters=[filtering.filter_empty_transcript])
    assert spans == jspans and status == jstatus and len(kept) == 4
    np.testing.assert_array_equal(np.asarray(c), np.asarray(jc))
    jds = jdatasets.TtsFineTuningDataset("ds", jkept, jc, jspans, jtk, 64, JNormalizer())
    ds = datasets.TtsFineTuningDataset("ds", kept, c, spans, tk, 64, BasicTextNormalizer())
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pretraining_datasets_match(tmp_path, toks):
    jtk, tk = toks
    d = str(tmp_path)
    flat = np.arange(100, dtype=np.int32) % 65536
    arr = np.memmap(os.path.join(d, "train_pretraining_codes.npy"), dtype=np.int32,
                    mode="w+", shape=(100,))
    arr[:] = flat
    arr.flush()
    jds = jdatasets.TtsPretrainingDataset(d, "train", 32, jtok.speech_vocab(jtk))
    ds = datasets.TtsPretrainingDataset(d, "train", 32, tokenization.speech_vocab(tk))
    assert len(ds) == len(jds) == 2
    for i in range(len(ds)):
        for k in ("input_ids", "labels"):
            np.testing.assert_array_equal(ds[i][k], jds[i][k])


def test_weighting_and_collate_match():
    class Fixed:
        def __init__(self, tag, n):
            self.tag, self.n = tag, n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            L = 10 + 30 * i
            return {"input_ids": np.arange(L, dtype=np.int32) + i,
                    "labels": np.arange(L, dtype=np.int32), "tokens_processed": L,
                    "audio_processed_sec": 0.5 * i}

    def parts(mod):
        return [mod.WeightedDataset("b", Fixed("b", 4), 0.5),
                mod.WeightedDataset("a", Fixed("a", 3), 2.0)]

    ds = datasets.CombinedDataset(parts(datasets))
    jds = jdatasets.CombinedDataset(parts(jdatasets))
    assert len(ds) == len(jds) == 8
    items = [ds[i] for i in range(len(ds))]
    for i, it in enumerate(items):
        assert it["source"] == jds[i]["source"]
        np.testing.assert_array_equal(it["input_ids"], jds[i]["input_ids"])
    for batch in (items[:3], items[3:]):
        out = collate.collate(batch, pad_token_id=0, max_seq_len=256)
        ref = jcollate.collate(batch, pad_token_id=0, max_seq_len=256)
        assert out.keys() == ref.keys()
        for k in ("input_ids", "labels"):
            np.testing.assert_array_equal(out[k], ref[k])
        assert collate.prettify_batch(out).keys() == jcollate.prettify_batch(ref).keys()


def test_loader_order_sharding_and_fast_forward_match():
    class Ds:
        def __init__(self):
            self.ff = False

        def enable_fast_forwarding(self):
            self.ff = True

        def disable_fast_forwarding(self):
            self.ff = False

        def __len__(self):
            return 32

        def __getitem__(self, i):
            if self.ff:
                return {}
            return {"input_ids": np.array([i], dtype=np.int32),
                    "labels": np.array([i], dtype=np.int32), "tokens_processed": 1,
                    "audio_processed_sec": 0.0}

    def ids(batches):
        return [b["input_ids"][:, 0].tolist() if b else {} for b in batches]

    for rank in (0, 1):
        kw = dict(seed=3, process_index=rank, process_count=2)
        ours = loader.DataLoader(Ds(), 8, lambda x: collate.collate(x, 0, max_seq_len=128),
                                 **kw)
        theirs = jloader.DataLoader(Ds(), 8, lambda x: jcollate.collate(x, 0, max_seq_len=128),
                                    **kw)
        for epoch in (0, 1):
            assert ids(ours.batches(epoch)) == ids(theirs.batches(epoch))
        assert ids(ours.batches(1, skip_batches=2)) == ids(theirs.batches(1, skip_batches=2))
        assert ids(ours.batches(1, skip_batches=2))[:2] == [{}, {}]


def test_builder_refuses_rlhf(tmp_path, toks):
    """``enable_rlhf_training`` no longer raises: the builder makes the
    RLHF prompt dataset, whose items equal the JAX builder's (this sample's
    codes and the next sample's transcript)."""
    from tts_max_tpu.data import builder as jbuilder

    jtk, tk = toks
    shards = [(np.arange(6, dtype=np.int32), np.array([0, 3]), _sample_dicts(2))]
    jdir, pdir = _write_both(tmp_path, "train", shards)
    cfg = config.DatasetConfig(enable_rlhf_training=True)
    ds, name = builder.build_dataset(tk, pdir, 64, "train", False, BasicTextNormalizer(), cfg)
    jds, jname = jbuilder.build_dataset(jtk, jdir, 64, "train", False, JNormalizer(),
                                        jconfig.DatasetConfig(enable_rlhf_training=True))
    assert type(ds).__name__ == type(jds).__name__ == "TtsRLHFDataset"
    assert len(ds) == len(jds) == 2 and name == "port" and jname == "jax"
    for i in range(2):
        ours, theirs = ds[i], jds[i]
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            if isinstance(ours[k], np.ndarray):
                np.testing.assert_array_equal(ours[k], theirs[k])
            else:
                assert ours[k] == theirs[k], k
    ds = builder.merge_datasets(tk, {pdir: 1.0}, 64, "train", False, BasicTextNormalizer(),
                                config.DatasetConfig())
    assert len(ds) == 2 and ds[0]["source"] == "port"
