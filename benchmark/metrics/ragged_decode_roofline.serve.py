"""Kernel C's (``csrc/ragged_decode.cu``) share of its roofline in the traced
slice of the serving window: the least time of every call (bytes of q, the
live K/V rows at each step's lengths, the lengths and the output,
``roofline.decode_attn``) over the device time of its kernels by name
(``tc_kernel`` over ``ContiguousRows`` and the split-K ``combine_kernel``).
Nothing is read unless the trace holds one call per layer and step."""

from benchmark import roofline
from benchmark.trace import device_seconds

NAME, UNIT, LAYER, SOURCE, MOVES = ("ragged_decode_roofline.serve", "%",
                                    "ops/ragged_decode.py (kernel C)", "device_trace",
                                    "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("trace"):
        return None
    cfg = obs["cfg"]
    steps = [rows for tag, s in obs["dispatch_rows"] if tag == "slice" for rows in s]
    kernel_s, calls = device_seconds(obs["trace"], "ContiguousRows")
    combine_s, _ = device_seconds(obs["trace"], "combine_kernel")
    if not steps or calls != len(steps) * cfg.n_layers or kernel_s <= 0:
        return None
    least = 0.0
    for rows in steps:
        flops, nbytes = roofline.decode_attn(rows, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        least += cfg.n_layers * roofline.least_seconds(flops, nbytes)
    return 100.0 * least / (kernel_s + combine_s)
