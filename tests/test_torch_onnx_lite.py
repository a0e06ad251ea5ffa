"""The port's ONNX interpreter (``tts_max_tpu_torch/utils/onnx_lite.py``)
against the JAX package's (``tts_max_tpu/utils/onnx_lite.py``) on the CPU:
the same ONNX bytes, written by the JAX module's encoder, parse to equal
graphs in both; every op group of the JAX module's tests and the rest of its
op table run through both executors within 1e-5 (fp32); and the DNSMOS
pipeline (``training/rlhf/dnsmos.py``: the P.808 mel features and
``DNSMOS.score`` over seeded graphs of convs, pools and a Gemm at DNSMOS's
input shapes) within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.training.rlhf import dnsmos as jdnsmos
from tts_max_tpu.utils import onnx_lite as jox
from tts_max_tpu_torch.training.rlhf import dnsmos
from tts_max_tpu_torch.utils import onnx_lite as ox

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _conv_pool_gemm():
    r = _rng(0)
    nodes = [
        jox.encode_node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[3, 3], strides=[2, 2],
                        pads=[1, 1, 1, 1]),
        jox.encode_node("Relu", ["c"], ["r"]),
        jox.encode_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
        jox.encode_node("Flatten", ["p"], ["f"], axis=1),
        jox.encode_node("Gemm", ["f", "lw", "lb"], ["g"], transB=1),
        jox.encode_node("Sigmoid", ["g"], ["y"]),
    ]
    inits = {"w": _f32(r, 4, 2, 3, 3), "b": _f32(r, 4), "lw": _f32(r, 5, 36), "lb": _f32(r, 5)}
    return nodes, inits, {"x": _f32(r, 2, 2, 12, 12)}


def _conv1d_groups_avgpool():
    r = _rng(1)
    nodes = [
        jox.encode_node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[5], pads=[2, 2],
                        group=2),
        jox.encode_node("AveragePool", ["c"], ["y"], kernel_shape=[3], strides=[3]),
    ]
    return nodes, {"w": _f32(r, 8, 2, 5), "b": _f32(r, 8)}, {"x": _f32(r, 1, 4, 30)}


def _batchnorm_softmax_reduce():
    r = _rng(2)
    nodes = [
        jox.encode_node("BatchNormalization", ["x", "s", "b", "m", "v"], ["n"]),
        jox.encode_node("ReduceMean", ["n"], ["r"], axes=[2, 3], keepdims=0),
        jox.encode_node("Softmax", ["r"], ["y"], axis=-1),
    ]
    inits = {"s": r.uniform(0.5, 2, 3).astype(np.float32), "b": _f32(r, 3),
             "m": _f32(r, 3), "v": r.uniform(0.5, 2, 3).astype(np.float32)}
    return nodes, inits, {"x": _f32(r, 2, 3, 4, 4)}


def _shape_gather_reshape():
    nodes = [
        jox.encode_node("Shape", ["x"], ["sh"]),
        jox.encode_node("Gather", ["sh", "i0"], ["d0"], axis=0),
        jox.encode_node("Concat", ["d0", "neg1"], ["tgt"], axis=0),
        jox.encode_node("Reshape", ["x", "tgt"], ["y"]),
    ]
    inits = {"i0": np.asarray([0], np.int64), "neg1": np.asarray([-1], np.int64)}
    return nodes, inits, {"x": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}


def _pad_slice_clip():
    nodes = [
        jox.encode_node("Pad", ["x"], ["p"], pads=[0, 1, 0, 1], mode=b"constant"),
        jox.encode_node("Slice", ["p"], ["s"], starts=[0], ends=[3], axes=[1]),
        jox.encode_node("Clip", ["s"], ["y"], min=0.0, max=1.0),
    ]
    return nodes, {}, {"x": np.asarray([[-1.0, 0.5, 2.0]], np.float32)}


def _same_autopad(mode):
    def build():
        r = _rng(3)
        nodes = [jox.encode_node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[4, 3],
                                 strides=[2, 1], auto_pad=mode),
                 jox.encode_node("AveragePool", ["c"], ["y"], kernel_shape=[3, 2],
                                 strides=[1, 1], auto_pad=mode)]
        return nodes, {"w": _f32(r, 2, 1, 4, 3), "b": _f32(r, 2)}, {"x": _f32(r, 1, 1, 7, 9)}
    return build


def _pad_modes():
    r = _rng(4)
    nodes = [
        jox.encode_node("Pad", ["x", "pads"], ["a"], mode=b"reflect"),
        jox.encode_node("Pad", ["a"], ["b"], pads=[0, 0, 2, 3], mode=b"edge"),
        jox.encode_node("Pad", ["b", "pads", "cval"], ["y"], mode=b"constant"),
    ]
    inits = {"pads": np.asarray([1, 2, 2, 1], np.int64), "cval": np.asarray(0.5, np.float32)}
    return nodes, inits, {"x": _f32(r, 3, 5)}


def _slice_steps_gather():
    r = _rng(5)
    nodes = [
        jox.encode_node("Slice", ["x", "st", "en", "ax", "sp"], ["s"]),
        jox.encode_node("Gather", ["s", "idx"], ["g"], axis=1),
        jox.encode_node("Transpose", ["g"], ["t"], perm=[3, 0, 2, 1]),
        jox.encode_node("Unsqueeze", ["t", "u"], ["un"]),
        jox.encode_node("Squeeze", ["un", "u"], ["y"]),
    ]
    inits = {"st": np.asarray([1, 7], np.int64), "en": np.asarray([9999999999, 0], np.int64),
             "ax": np.asarray([0, 1], np.int64), "sp": np.asarray([2, -2], np.int64),
             "idx": np.asarray([[0, -1], [1, 1]], np.int64), "u": np.asarray([1], np.int64)}
    return nodes, inits, {"x": _f32(r, 6, 8, 3)}


def _elementwise():
    r = _rng(6)
    nodes = [
        jox.encode_node("Mul", ["x", "y0"], ["m"]),
        jox.encode_node("Div", ["m", "d"], ["dv"]),
        jox.encode_node("Sub", ["dv", "x"], ["s"]),
        jox.encode_node("Abs", ["s"], ["a"]),
        jox.encode_node("Add", ["a", "one"], ["a1"]),
        jox.encode_node("Pow", ["a1", "half"], ["pw"]),
        jox.encode_node("Sqrt", ["pw"], ["sq"]),
        jox.encode_node("Log", ["sq"], ["lg"]),
        jox.encode_node("Exp", ["lg"], ["ex"]),
        jox.encode_node("Tanh", ["ex"], ["th"]),
        jox.encode_node("Erf", ["x"], ["ef"]),
        jox.encode_node("Softplus", ["x"], ["sp"]),
        jox.encode_node("LeakyRelu", ["x"], ["lr"], alpha=0.2),
        jox.encode_node("Elu", ["x"], ["el"], alpha=0.7),
        jox.encode_node("HardSigmoid", ["x"], ["hs"], alpha=0.3, beta=0.4),
        jox.encode_node("Neg", ["x"], ["ng"]),
        jox.encode_node("Floor", ["x"], ["fl"]),
        jox.encode_node("Ceil", ["x"], ["ce"]),
        jox.encode_node("Reciprocal", ["a1"], ["rc"]),
        jox.encode_node("Min", ["th", "ef"], ["mn"]),
        jox.encode_node("Max", ["sp", "lr"], ["mx"]),
        jox.encode_node("Greater", ["x", "y0"], ["gt"]),
        jox.encode_node("Less", ["x", "y0"], ["lt"]),
        jox.encode_node("Or", ["gt", "lt"], ["orr"]),
        jox.encode_node("Not", ["orr"], ["nt"]),
        jox.encode_node("And", ["gt", "nt"], ["an"]),
        jox.encode_node("Equal", ["fl", "ce"], ["eq"]),
        jox.encode_node("Where", ["gt", "el", "hs"], ["wh"]),
        jox.encode_node("Cast", ["eq"], ["eqf"], to=1),
        jox.encode_node("Concat", ["mn", "mx", "wh", "ng", "rc", "eqf", "fl", "ce"], ["cat"],
                        axis=0),
        jox.encode_node("Identity", ["cat"], ["id"]),
        jox.encode_node("Dropout", ["id"], ["y"]),
    ]
    inits = {"y0": _f32(r, 4, 5), "d": r.uniform(1, 2, (1, 5)).astype(np.float32),
             "one": np.asarray(1.0, np.float32), "half": np.asarray(0.5, np.float32)}
    return nodes, inits, {"x": _f32(r, 4, 5) * 2}


def _reductions_matmul():
    r = _rng(7)
    nodes = [
        jox.encode_node("MatMul", ["x", "w"], ["mm"]),
        jox.encode_node("ReduceSum", ["mm", "ax"], ["rs"], keepdims=1),
        jox.encode_node("ReduceMax", ["mm"], ["rx"], axes=[2], keepdims=0),
        jox.encode_node("ReduceMin", ["mm"], ["rn"], axes=[2], keepdims=0),
        jox.encode_node("ReduceMean", ["mm"], ["rm"], keepdims=1),
        jox.encode_node("Expand", ["rm", "shape"], ["ex"]),
        jox.encode_node("Add", ["ex", "rs"], ["y"]),
        jox.encode_node("Sub", ["rx", "rn"], ["z"]),
        jox.encode_node("Clip", ["z", "lo", "hi"], ["zc"]),
    ]
    inits = {"w": _f32(r, 5, 6), "ax": np.asarray([1], np.int64),
             "shape": np.asarray([2, 3, 6], np.int64),
             "lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.5, np.float32)}
    return nodes, inits, {"x": _f32(r, 2, 3, 5)}


def _global_pools_constants():
    r = _rng(8)
    nodes = [
        jox.encode_node("GlobalAveragePool", ["x"], ["ga"]),
        jox.encode_node("GlobalMaxPool", ["x"], ["gm"]),
        jox.encode_node("Shape", ["ga"], ["sh"]),
        jox.encode_node("ConstantOfShape", ["sh"], ["cs"], value=np.asarray([0.25], np.float32)),
        jox.encode_node("Constant", [], ["k"], value=np.asarray([2.0], np.float32)),
        jox.encode_node("Mul", ["gm", "k"], ["gm2"]),
        jox.encode_node("Add", ["ga", "cs"], ["g1"]),
        jox.encode_node("Sub", ["g1", "gm2"], ["y"]),
        jox.encode_node("AveragePool", ["x"], ["ap"], kernel_shape=[3, 3], strides=[2, 2],
                        pads=[1, 1, 1, 1]),
        jox.encode_node("AveragePool", ["x"], ["api"], kernel_shape=[3, 3], strides=[2, 2],
                        pads=[1, 0, 1, 2], count_include_pad=1),
        jox.encode_node("MaxPool", ["x"], ["mp"], kernel_shape=[2, 3], strides=[1, 2],
                        pads=[0, 1, 1, 1]),
    ]
    return nodes, {}, {"x": _f32(r, 2, 3, 7, 6)}


GROUPS = {
    "conv_relu_pool_gemm": (_conv_pool_gemm, ["y"]),
    "conv1d_groups_avgpool": (_conv1d_groups_avgpool, ["y"]),
    "batchnorm_softmax_reduce": (_batchnorm_softmax_reduce, ["y"]),
    "shape_gather_reshape": (_shape_gather_reshape, ["y"]),
    "pad_slice_clip": (_pad_slice_clip, ["y"]),
    "same_upper_autopad": (_same_autopad(b"SAME_UPPER"), ["y"]),
    "same_lower_autopad": (_same_autopad(b"SAME_LOWER"), ["y"]),
    "pad_reflect_edge_constant": (_pad_modes, ["y"]),
    "slice_steps_gather_transpose": (_slice_steps_gather, ["y"]),
    "elementwise": (_elementwise, ["y"]),
    "reductions_matmul_expand": (_reductions_matmul, ["y", "zc"]),
    "global_pools_constants": (_global_pools_constants, ["y", "ap", "api", "mp"]),
}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_op_group_matches_jax(name):
    build, outputs = GROUPS[name]
    nodes, inits, feeds = build()
    data = jox.build_model_bytes(nodes, list(feeds) + list(inits), outputs, inits)
    assert ox.build_model_bytes(nodes, list(feeds) + list(inits), outputs, inits) == data
    want = jox.run(jox.parse_model(data), {k: jnp.asarray(v) for k, v in feeds.items()})
    got = ox.run(ox.parse_model(data), {k: torch.from_numpy(v) for k, v in feeds.items()},
                 device="cpu")
    runner = ox.make_runner(ox.parse_model(data), device="cpu")
    again = runner(**feeds)
    for o, g, w, a in zip(outputs, got, want, again):
        g, w, a = ox._np(g), np.asarray(w), ox._np(a)
        assert g.shape == w.shape, (o, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=TOL,
                                   rtol=TOL, err_msg=o)
        np.testing.assert_array_equal(a, g)


def test_parse_equal_to_jax():
    """The same bytes parse to the same nodes, attributes, initializers and
    names in both modules (the parser is a copy)."""
    for build, outputs in GROUPS.values():
        nodes, inits, feeds = build()
        data = jox.build_model_bytes(nodes, list(feeds), outputs, inits)
        a, b = ox.parse_model(data), jox.parse_model(data)
        assert (a.input_names, a.output_names, a.feed_names) == (
            b.input_names, b.output_names, b.feed_names)
        assert sorted(a.initializers) == sorted(b.initializers)
        for k in a.initializers:
            assert a.initializers[k].dtype == b.initializers[k].dtype
            np.testing.assert_array_equal(a.initializers[k], b.initializers[k])
        assert len(a.nodes) == len(b.nodes)
        for na, nb in zip(a.nodes, b.nodes):
            assert (na.op_type, na.inputs, na.outputs, na.name) == (
                nb.op_type, nb.inputs, nb.outputs, nb.name)
            assert sorted(na.attrs) == sorted(nb.attrs)
            for key in na.attrs:
                va, vb = na.attrs[key].value, nb.attrs[key].value
                if isinstance(va, np.ndarray):
                    np.testing.assert_array_equal(va, vb)
                else:
                    assert va == vb, (na.op_type, key)


# --- DNSMOS -------------------------------------------------------------------


def dnsmos_graphs(seed: int = 0, width: int = 8):
    """Seeded stand-ins for DNSMOS's two graphs at its inputs, from convs,
    pools and a Gemm: ``sig_bak_ovr`` (raw [1, 144160] -> [1, 3]) and
    ``model_v8`` (mel [1, T, 120] -> [1, 1])."""
    r = _rng(seed)
    c = width
    primary = jox.build_model_bytes([
        jox.encode_node("Unsqueeze", ["input_1", "ax1"], ["x"]),
        jox.encode_node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[400], strides=[160]),
        jox.encode_node("Relu", ["c1"], ["r1"]),
        jox.encode_node("MaxPool", ["r1"], ["p1"], kernel_shape=[4], strides=[4]),
        jox.encode_node("Conv", ["p1", "w2", "b2"], ["c2"], kernel_shape=[3],
                        auto_pad=b"SAME_UPPER"),
        jox.encode_node("Relu", ["c2"], ["r2"]),
        jox.encode_node("GlobalAveragePool", ["r2"], ["g"]),
        jox.encode_node("Flatten", ["g"], ["f"], axis=1),
        jox.encode_node("Gemm", ["f", "wd", "bd"], ["out"], transB=1),
    ], ["input_1"], ["out"], {
        "ax1": np.asarray([1], np.int64),
        "w1": _f32(r, c, 1, 400) * 0.05, "b1": _f32(r, c) * 0.1,
        "w2": _f32(r, c, c, 3) * 0.3, "b2": _f32(r, c) * 0.1,
        "wd": _f32(r, 3, c), "bd": np.asarray([3.0, 3.5, 3.2], np.float32)})
    p808 = jox.build_model_bytes([
        jox.encode_node("Unsqueeze", ["input_1", "ax1"], ["x"]),
        jox.encode_node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[3, 3],
                        pads=[1, 1, 1, 1]),
        jox.encode_node("Relu", ["c1"], ["r1"]),
        jox.encode_node("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2], strides=[2, 2]),
        jox.encode_node("BatchNormalization", ["p1", "s", "bb", "m", "v"], ["n1"]),
        jox.encode_node("GlobalMaxPool", ["n1"], ["g"]),
        jox.encode_node("Flatten", ["g"], ["f"], axis=1),
        jox.encode_node("Gemm", ["f", "wd", "bd"], ["out"], transB=1),
    ], ["input_1"], ["out"], {
        "ax1": np.asarray([1], np.int64),
        "w1": _f32(r, c, 1, 3, 3) * 0.3, "b1": _f32(r, c) * 0.1,
        "s": np.ones(c, np.float32), "bb": np.zeros(c, np.float32),
        "m": np.zeros(c, np.float32), "v": np.ones(c, np.float32),
        "wd": _f32(r, 1, c) * 0.1, "bd": np.asarray([3.0], np.float32)})
    return primary, p808


@pytest.fixture(scope="module")
def dnsmos_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dnsmos")
    primary, p808 = dnsmos_graphs()
    (d / "sig_bak_ovr.onnx").write_bytes(primary)
    (d / "model_v8.onnx").write_bytes(p808)
    return str(d / "sig_bak_ovr.onnx"), str(d / "model_v8.onnx")


def test_audio_melspec_matches_jax():
    wav = (np.sin(2 * np.pi * 440 * np.arange(20000) / 16000)
           + _rng(9).standard_normal(20000) * 0.05).astype(np.float32)
    got = dnsmos.audio_melspec(wav, device="cpu")
    want = jdnsmos.audio_melspec(wav)
    assert got.shape == want.shape == (125, 120)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seconds,sr", [(2.0, 16000), (10.5, 16000), (1.5, 24000)])
def test_dnsmos_score_matches_jax(dnsmos_files, seconds, sr):
    """Short clips repeat to one segment, 10.5 s takes two hops, 24 kHz is
    resampled first; all four scores within 1e-4, and the call counters."""
    wav = (_rng(10).standard_normal(int(seconds * sr)) * 0.1).astype(np.float32)
    fn = dnsmos.load_dnsmos(*dnsmos_files, device="cpu")
    got = fn.score(wav, sr)
    want = jdnsmos.load_dnsmos(*dnsmos_files).score(wav, sr)
    assert set(got) == set(want) == {"p808", "sig", "bak", "ovr"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert fn(wav, sr) == pytest.approx(got["ovr"])
    assert (fn.calls, fn.completed) == (1, 1)


def test_dnsmos_env_dir(dnsmos_files, monkeypatch):
    import os

    monkeypatch.setenv("DNSMOS_ONNX_DIR", os.path.dirname(dnsmos_files[0]))
    fn = dnsmos.load_dnsmos(device="cpu")
    wav = np.zeros(16000, np.float32)
    wav[::100] = 0.1
    assert np.isfinite(fn(wav, 16000))
    with pytest.raises(ValueError):
        dnsmos.DNSMOS(None, None, device="cpu")
