"""Blocked KGE candidate scoring (port of ``repro/kernels/kge_score.py``).

Every registered decoder reduces to the query form
(``repro_torch.models.decoders``)::

    scores[b, c] = epilogue(q[b]·C'[c] + q_bias[b] + c_bias[c]) + bias[b, c]

with two epilogue families: ``bilinear`` (identity; DistMult, ComplEx) and
``neg_l2`` (``-sqrt(max(x, 0) + NORM_EPS)``; TransE, RotatE through the
norm expansion, eps under the sqrt). ``bias`` is added after the epilogue
(0, ``FILTER_BIAS`` or ``-inf``).

:func:`kge_score` launches the register-tiled CUDA kernel of
``csrc/kge_score.cu`` for CUDA tensors and runs :func:`kge_score_plain` for
CPU tensors. Each score is one fixed-order fp32 sum over ``d`` in the
kernel, so a candidate's score has the same bits whatever block it is
scored in; :func:`kge_score_v1`, the first kernel, sums in the same order
and gives the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NORM_EPS = 1e-9          # safe-norm eps, under the sqrt
EPILOGUES = ("bilinear", "neg_l2")
# the first kernel's (128, d) candidate tile fits in shared memory up to
# this d (the tiled kernel stages d in slices and has no such limit; the
# limit stays so that both kernels take every accepted shape)
MAX_DIM = 384
MAX_BATCH = 8 * 65535    # the first kernel's grid: 8 query rows per block

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
_SIGNATURES = {"kge_score_f32": _ARGTYPES, "kge_score_f32_v1": _ARGTYPES}


def apply_epilogue(x: torch.Tensor, epilogue: str) -> torch.Tensor:
    """The elementwise, monotone epilogue families — the one definition of
    the score non-linearity outside the kernel."""
    if epilogue == "bilinear":
        return x
    if epilogue == "neg_l2":
        # the fp32 sqrt goes through fp64: PyTorch's vectorized CPU fp32
        # sqrt can be 1 ulp off (sqrt(4.171875) on AVX-512), while XLA and
        # the kernel's sqrtf round correctly; an fp64 sqrt rounded to fp32
        # is the correctly rounded fp32 sqrt (53 >= 2 * 24 + 2 bits)
        y = torch.clamp_min(x, 0.0) + NORM_EPS
        return -torch.sqrt(y.double()).to(x.dtype)
    raise ValueError(f"unknown epilogue {epilogue!r}; known: {EPILOGUES}")


def kge_score_plain(q: torch.Tensor, candidates: torch.Tensor,
                    bias: torch.Tensor, q_bias: torch.Tensor,
                    c_bias: torch.Tensor, *,
                    epilogue: str = "bilinear") -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(B, d)`` queries, ``(C, d)``
    candidates, ``(B, C)`` post-epilogue bias, ``(B,)`` and ``(C,)``
    pre-epilogue biases → ``(B, C)`` fp32. On the card the product runs in
    full fp32 (TF32 off), as the kernel does."""
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    x = q @ candidates.T + q_bias[:, None] + c_bias[None, :]
    return apply_epilogue(x, epilogue) + bias


def _launch(entry: str, q, candidates, bias, q_bias, c_bias,
            epilogue: str) -> torch.Tensor:
    """Check the operands and launch the C entry point ``entry``."""
    if q.dim() != 2 or candidates.dim() != 2:
        raise ValueError("kge_score: q and candidates must be 2-D")
    b, d = q.shape
    c = candidates.shape[0]
    f32 = torch.float32
    _build.require("kge_score", "q", q, f32, (b, d))
    _build.require("kge_score", "candidates", candidates, f32, (c, d))
    _build.require("kge_score", "bias", bias, f32, (b, c))
    _build.require("kge_score", "q_bias", q_bias, f32, (b,))
    _build.require("kge_score", "c_bias", c_bias, f32, (c,))
    if not 1 <= d <= MAX_DIM or b > MAX_BATCH:
        raise ValueError(f"kge_score: d={d} must lie in [1, {MAX_DIM}] and "
                         f"B={b} at most {MAX_BATCH}")
    out = torch.empty((b, c), dtype=f32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("kge_score", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), candidates.data_ptr(), bias.data_ptr(),
            q_bias.data_ptr(), c_bias.data_ptr(), out.data_ptr(), b, c, d,
            int(epilogue == "neg_l2"), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("kge_score", code)
    return out


def kge_score_ops(b: int, c: int, d: int) -> int:
    """Operations of the scores: the ``(B, d) x (d, C)`` product."""
    return 2 * b * c * d


def kge_score_bytes(b: int, c: int, d: int) -> int:
    """Bytes the scores must move, fp32: q, the candidates, both bias
    vectors and the ``(B, C)`` bias read, the ``(B, C)`` scores
    written."""
    return 4 * (b * d + c * d + b + c + 2 * b * c)


def kge_score(q: torch.Tensor, candidates: torch.Tensor, bias: torch.Tensor,
              q_bias: torch.Tensor, c_bias: torch.Tensor, *,
              epilogue: str = "bilinear") -> torch.Tensor:
    """``epilogue(q @ candidates.T + q_bias[:, None] + c_bias) + bias`` —
    the register-tiled CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Ragged ``B`` and ``C`` are taken as they are. Fake
    tensors take the abstract branch (the dry run)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {EPILOGUES}")
    if _build.is_abstract(q, candidates, bias, q_bias, c_bias):
        from repro_torch.sharding.step_analysis import local_kernel_call
        (b, d), c = q.shape, candidates.shape[0]
        return local_kernel_call(
            "kge_score", lambda q, *_: torch.empty(
                (b, c), dtype=torch.float32, device=q.device),
            (q, candidates, bias, q_bias, c_bias),
            lambda *_: kge_score_ops(b, c, d),
            lambda *_: kge_score_bytes(b, c, d))
    if _build.on_cpu("kge_score", q, candidates, bias, q_bias, c_bias):
        return kge_score_plain(q, candidates, bias, q_bias, c_bias,
                               epilogue=epilogue)
    out = _launch("kge_score_f32", q, candidates, bias, q_bias, c_bias,
                  epilogue)
    if out.numel():
        kge_score.launches += 1
    return out


kge_score.launches = 0


def kge_score_v1(q: torch.Tensor, candidates: torch.Tensor,
                 bias: torch.Tensor, q_bias: torch.Tensor,
                 c_bias: torch.Tensor, *,
                 epilogue: str = "bilinear") -> torch.Tensor:
    """The first port's kernel (one thread per candidate row, 8 queries per
    block) on CUDA tensors, kept as the bitwise yardstick of
    :func:`kge_score`: both sum every score in the same fixed order. Not
    on any path of the port; it counts no launches."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {EPILOGUES}")
    if _build.on_cpu("kge_score", q, candidates, bias, q_bias, c_bias):
        raise ValueError("kge_score_v1: CUDA tensors only (the plain "
                         "version is kge_score_plain)")
    return _launch("kge_score_f32_v1", q, candidates, bias, q_bias, c_bias,
                   epilogue)
