"""Kernel A''s (``csrc/flash_attention_bwd.cu``, bf16 on the tensor cores:
``bwd_delta``, ``bwd_dkdv_tc``, ``bwd_dq_tc``) share of its roofline in the
traced training step: the least time of each layer's backward at its
batch's bucket (``roofline.attn_bwd``) over the device time of its three
kernels. Nothing is read unless the trace holds one call of each a layer."""

from benchmark import roofline
from benchmark.trace import device_seconds

NAME, UNIT, LAYER, SOURCE, MOVES = ("flash_attn_bwd_roofline.train", "%",
                                    "ops/flash_attention.py (kernel A')", "device_trace",
                                    "train_tokens_per_s")


def read(obs):
    if obs.get("kind") != "train" or not obs.get("trace"):
        return None
    cfg = obs["cfg"]
    want = cfg.n_layers * len(obs["traced_batches"])
    secs = 0.0
    for name in ("bwd_delta", "bwd_dkdv_tc", "bwd_dq_tc"):
        s, calls = device_seconds(obs["trace"], name)
        if calls != want:
            return None
        secs += s
    least = sum(cfg.n_layers * roofline.least_seconds(*roofline.attn_bwd(
        b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)) for b, s in obs["traced_batches"])
    return 100.0 * least / secs
