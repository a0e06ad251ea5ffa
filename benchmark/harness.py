"""What every cell of the benchmark shares: the files it finds by name, the
card check, the model configuration, the seeded weights, and the statistics
its metrics are made of.

Nothing here imports the program (``tts_max_tpu_torch``) at module level:
the reference and the tests import this module too.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent

# top-level module names that must never be loaded in a run (compared whole,
# so the port, ``tts_max_tpu_torch``, does not match ``tts_max_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tts_max_tpu")


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``: a configuration, a traffic mix or a
    cell's workload file."""
    path = ROOT / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those whose ``workloads`` list names it, or that have no such list."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def load_metric(name: str):
    """The reader module ``benchmark/metrics/<name>.py`` (its file name may
    hold dots, so it is loaded by path)."""
    path = ROOT / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, one
    OpenMP thread, and no library that would load JAX by itself (call it
    before torch is imported). The port's own ``nvcc`` builds
    go to ``build/kernels/`` inside the checkout (``ops/cuda_build.py``)."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # one process with few threads: the host side launches kernels from one
    # thread, and idle OpenMP workers only add noise to a host-bound step
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_loaded(modules=None) -> list[str]:
    """Forbidden top-level names among the loaded modules, compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class HostClock:
    """What the host did over a stretch of the run, for the log: the calling
    thread's CPU seconds against the wall's (how much of the time the
    thread that launches the work was on a CPU), and the seconds Python's
    garbage collector took."""

    def __init__(self):
        import gc
        import time

        self._gc, self._time = gc, time
        self.gc_s, self._gc_t = 0.0, None
        self.wall, self.cpu = time.perf_counter(), time.thread_time()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = self._time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += self._time.perf_counter() - self._gc_t
            self._gc_t = None

    def stop(self) -> str:
        self._gc.callbacks.remove(self._on_gc)
        wall = self._time.perf_counter() - self.wall
        cpu = self._time.thread_time() - self.cpu
        return (f"{wall:.3f} s of wall, the launching thread on a CPU {cpu:.3f} s, "
                f"garbage collection {self.gc_s:.4f} s")


# --- the model configuration -------------------------------------------------


def model_config(conf: dict, **over):
    """The port's ``LlamaConfig`` for a configuration file of published
    ``config.json`` keys (``head_dim`` is hidden / heads where the source
    does not state it)."""
    import torch

    from tts_max_tpu_torch.models.llama import LlamaConfig

    if conf.get("rope_scaling"):
        raise ValueError("the benchmark's configurations use unscaled rotary embeddings only "
                         "(as its reference computes them)")
    kw = dict(
        vocab_size=conf["vocab_size"],
        dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"],
        ffn_dim=conf["intermediate_size"],
        norm_eps=conf["rms_norm_eps"],
        rope_theta=float(conf["rope_theta"]),
        use_llama3_rope_scaling=False,
        max_seq_len=conf["max_position_embeddings"],
        tie_embeddings=conf["tie_word_embeddings"],
        dtype=getattr(torch, conf["torch_dtype"]),
    )
    kw.update(over)
    return LlamaConfig(**kw)


# --- seeded weights -------------------------------------------------------------


def weight_layout(cfg) -> list[tuple[tuple[str, ...], tuple[int, ...], float | None]]:
    """(path in the parameter tree, shape, std) of every weight, in the
    port's layout (dense kernels ``[in, out]``, layers stacked on a leading
    axis). A std of None marks an RMSNorm scale."""
    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out = [
        (("embed", "embedding"), (cfg.vocab_size, D), 0.02),
        (("layers", "attn_norm", "scale"), (L, D), None),
        (("layers", "mlp_norm", "scale"), (L, D), None),
        (("layers", "attn", "wq", "kernel"), (L, D, q), D ** -0.5),
        (("layers", "attn", "wk", "kernel"), (L, D, kv), D ** -0.5),
        (("layers", "attn", "wv", "kernel"), (L, D, kv), D ** -0.5),
        (("layers", "attn", "wo", "kernel"), (L, q, D), q ** -0.5),
        (("layers", "mlp", "w_gate", "kernel"), (L, D, F), D ** -0.5),
        (("layers", "mlp", "w_up", "kernel"), (L, D, F), D ** -0.5),
        (("layers", "mlp", "w_down", "kernel"), (L, F, D), F ** -0.5),
        (("norm", "scale"), (D,), None),
    ]
    if not cfg.tie_embeddings:
        out.append((("lm_head", "kernel"), (D, cfg.vocab_size), D ** -0.5))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(cfg, seed: int, device) -> dict:
    """The model's weights drawn from ``seed`` on ``device`` in two calls:
    one normal draw of every matrix into a flat buffer of the served dtype,
    scaled leaf by leaf to its std (fan_in^-1/2, the embedding 0.02), and
    one draw of every RMSNorm scale (fp32, 1 + 0.1 N(0, 1)). The same seed
    gives the same bits, so the reference draws them again for itself."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    layout = weight_layout(cfg)
    align = 64  # elements: every leaf starts 128-byte aligned

    def offsets(entries):
        offs, n = [], 0
        for _, shape, _ in entries:
            offs.append(n)
            n += -(-_numel(shape) // align) * align
        return offs, n

    mats = [e for e in layout if e[2] is not None]
    norms = [e for e in layout if e[2] is None]
    m_off, m_n = offsets(mats)
    n_off, n_n = offsets(norms)
    flat = torch.empty(m_n, dtype=cfg.dtype, device=device)
    flat.normal_(generator=gen)
    flat_n = torch.empty(n_n, dtype=torch.float32, device=device)
    flat_n.normal_(mean=1.0, std=0.1, generator=gen)
    tree: dict = {}

    def put(path, t):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t

    for (path, shape, std), off in zip(mats, m_off):
        put(path, flat[off:off + _numel(shape)].view(shape).mul_(std))
    for (path, shape, _), off in zip(norms, n_off):
        put(path, flat_n[off:off + _numel(shape)].view(shape))
    return tree


# --- statistics --------------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) over every value, by linear
    interpolation between closest ranks (``statistics.quantiles``'
    inclusive method)."""
    values = sorted(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[round(q) - 1])


def interval_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total
