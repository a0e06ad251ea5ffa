"""Kernel G: the codec encoder's fused anti-aliased SnakeBeta
(``csrc/act1d.cu``), its plain version, and the Kaiser-sinc taps and
SnakeBeta both are built from.

Replaces the JAX package's Pallas ``activation1d_pallas``
(``tts_max_tpu/ops/pallas_act1d.py``). On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version,
``activation1d_fused``, which has the kernel's arithmetic. There is no
fallback from one to the other: a CUDA input the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tts_max_tpu_torch.ops import cuda_build

# The kernel's strips (csrc/act1d.cu): a thread walks R output rows of one
# channel of one sequence, in trips of 6 rows (the rings' length); each R is
# a compiled instantiation.
STRIP_ROWS = (48, 24, 12)
TRIP = 6
SMS = 132  # the H100's SMs
WARPS_PER_SM = 24  # resident at the kernel's 80 registers: 6 blocks of 4 warps


def kaiser_beta(half_size: int, half_width: float) -> float:
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


@functools.lru_cache(maxsize=64)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Windowed-sinc low-pass taps, sum-normalized. Returns [kernel_size]
    float32 (read-only: the array is cached)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    beta = kaiser_beta(half_size, half_width)
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        taps = np.zeros(kernel_size, dtype=np.float32)
    else:
        taps = 2 * cutoff * window * np.sinc(2 * cutoff * time)
        taps = (taps / taps.sum()).astype(np.float32)
    taps.flags.writeable = False
    return taps


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               logscale: bool = True) -> torch.Tensor:
    """x + (1/b) sin^2(a x) in fp32 (SnakeBeta); alpha, beta per channel [C],
    log-scale by default."""
    a = torch.exp(alpha) if logscale else alpha
    b = torch.exp(beta) if logscale else beta
    xf = x.float()
    y = xf + (1.0 / (b.float() + 1e-9)) * torch.square(torch.sin(xf * a.float()))
    return y.to(x.dtype)


def act1d_taps() -> tuple[list[float], list[float], list[float], list[float]]:
    """The fused sandwich's four 6-tap filters (up-even, up-odd, down over
    the even stream, down over the odd stream), from t = kaiser(0.25, 0.3,
    12): the up and down filters are the same taps at ratio 2."""
    t = kaiser_sinc_filter1d(0.25, 0.3, 12)
    te = [2.0 * float(t[11 - 2 * m]) for m in range(6)]
    to = [2.0 * float(t[10 - 2 * m]) for m in range(6)]
    td_e = [float(t[2 * m + 1]) for m in range(6)]
    td_o = [float(t[2 * m]) for m in range(6)]
    return te, to, td_e, td_o


def activation1d_fused(x: torch.Tensor, p) -> torch.Tensor:
    """up-2x -> SnakeBeta -> down-2x (ratio 2, K = 12) as tap-shifted sums:
    the plain version of kernel G.

    With xp = edge_pad(x, 5) and the taps of ``act1d_taps``, the up stream
    at even/odd parity is
        E[n] = sum_m te[m] xp[n+m+2],  O[n] = sum_m to[m] xp[n+m+3]
    (m in [0, 6)); SnakeBeta applies to each stream; the down conv's edge
    padding of the 2x-rate signal clamps to E[0] on the left and O[T-1] on
    the right, giving
        E_ext = [E0, E0, E, O_{T-1} x3],  O_ext = [E0 x3, O, O_{T-1} x2]
        y[n] = sum_m td_e[m] E_ext[n+m] + td_o[m] O_ext[n+m].
    """
    te, to, td_e, td_o = act1d_taps()
    t = x.shape[1]
    idx = torch.arange(-5, t + 5, device=x.device).clamp_(0, t - 1)
    xp = x[:, idx]

    def tapsum(base, offs, taps):
        acc = taps[0] * base[:, offs: offs + t]
        for m in range(1, 6):
            acc = acc + taps[m] * base[:, offs + m: offs + m + t]
        return acc

    e = snake_beta(tapsum(xp, 2, te), p["alpha"], p["beta"])
    o = snake_beta(tapsum(xp, 3, to), p["alpha"], p["beta"])
    first, last = e[:, :1], o[:, t - 1:]
    e_ext = torch.cat([first.expand(-1, 2, -1), e, last.expand(-1, 3, -1)], dim=1)
    o_ext = torch.cat([first.expand(-1, 3, -1), o, last.expand(-1, 2, -1)], dim=1)
    return tapsum(e_ext, 0, td_e) + tapsum(o_ext, 0, td_o)


def launch_warps(b: int, t: int, c: int, rows: int) -> int:
    """Warps of a launch: one thread per (sequence, strip of ``rows`` rows,
    channel)."""
    return -(-b * -(-t // rows) * c // 32)


def launch_rows(b: int, t: int, c: int) -> int:
    """R for kernel G on [b, t, c]: the longest strip whose launch still
    fills every SM's resident warps once (``WARPS_PER_SM``), else the
    shortest. A long strip wastes the least on its warm-up (5 pairs and 10
    x rows against R rows); a launch that leaves resident slots empty
    wastes more (PERF.md section 6)."""
    for rows in STRIP_ROWS:
        if launch_warps(b, t, c, rows) >= WARPS_PER_SM * SMS:
            return rows
    return STRIP_ROWS[-1]


def activation1d_kernel(x: torch.Tensor, p) -> torch.Tensor:
    """x: [B, T, C] fp32 -> [B, T, C]: up-2x -> SnakeBeta (log-scale
    ``p["alpha"]``, ``p["beta"]`` [C]) -> down-2x, ratio 2, 12 taps."""
    alpha, beta = p["alpha"], p["beta"]
    if x.dim() != 3 or alpha.shape != (x.shape[2],) or beta.shape != alpha.shape:
        raise ValueError(f"x {tuple(x.shape)}, alpha {tuple(alpha.shape)}, "
                         f"beta {tuple(beta.shape)}: need [B, T, C] and [C]")
    if x.device.type == "cpu":
        return activation1d_fused(x, p)
    if x.device.type != "cuda" or alpha.device != x.device or beta.device != x.device:
        raise ValueError(f"x, alpha, beta must share one CUDA device, got "
                         f"{x.device}, {alpha.device}, {beta.device}")
    if x.dtype != torch.float32 or alpha.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"dtypes {x.dtype}/{alpha.dtype}/{beta.dtype}: kernel G takes fp32")
    if not (x.is_contiguous() and alpha.is_contiguous() and beta.is_contiguous()):
        raise ValueError("x, alpha, beta must be contiguous")
    b, t, c = x.shape
    if min(b, t, c) < 1:
        raise ValueError(f"shape {tuple(x.shape)}: need B, T, C >= 1")
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.act1d_fwd(x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), _taps(),
                        out.data_ptr(), b, t, c, launch_rows(b, t, c),
                        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "act1d_fwd")
    activation1d_kernel.launches += 1
    return out


activation1d_kernel.launches = 0

_TAPS = None


def _taps():
    """The 24 taps (up-even, up-odd, down-even, down-odd) as a C float
    array, in the fp32 values the plain version multiplies by."""
    global _TAPS
    if _TAPS is None:
        taps = [v for group in act1d_taps() for v in group]
        _TAPS = (ctypes.c_float * 24)(*taps)
    return _TAPS


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("act1d")
    fn = lib.act1d_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_float), p, i, i, i, i, p]
        fn.restype = i
    return lib
