"""Kernel A's (``csrc/flash_attention.cu``, bf16 on the tensor cores) share
of its roofline in the traced training step: the least time of each call at
its batch's bucket (``roofline.attn_fwd``: causal over the padded length,
as the step computes it) over the device time of ``flash_fwd_tc``. A step
under full remat calls it twice a layer (the forward and the recompute);
nothing is read unless the trace holds exactly those calls."""

from benchmark import roofline
from benchmark.trace import device_seconds

NAME, UNIT, LAYER, SOURCE, MOVES = ("flash_attn_fwd_roofline.train", "%",
                                    "ops/flash_attention.py (kernel A)", "device_trace",
                                    "train_tokens_per_s")


def read(obs):
    if obs.get("kind") != "train" or not obs.get("trace"):
        return None
    cfg = obs["cfg"]
    secs, calls = device_seconds(obs["trace"], "flash_fwd_tc")
    if secs <= 0 or calls != 2 * cfg.n_layers * len(obs["traced_batches"]):
        return None
    least = sum(2 * cfg.n_layers * roofline.least_seconds(*roofline.attn_fwd(
        b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)) for b, s in obs["traced_batches"])
    return 100.0 * least / secs
