"""KG-embedding decoders in the canonical query form (port of
``repro/models/decoders.py``).

Every decoder is a registered :class:`Decoder` whose contract is

    ``prepare_query(params, h_s, rel)   -> (q, q_bias)``     (B, d), (B,)
    ``prepare_candidates(params, C)     -> (C', c_bias)``   (..., d), (...)
    ``scores = epilogue(q @ C'^T + q_bias[:, None] + c_bias)``

with the epilogue families of ``repro_torch.kernels.kge_score``:
``bilinear`` for DistMult and ComplEx, ``neg_l2`` for TransE and RotatE
(norm expansion ``‖u − c‖² = ‖u‖² + ‖c‖² − 2 u·c``: ``q = −2u``,
``q_bias = ‖u‖²``, ``c_bias = ‖c‖²``).

Parameters are dictionaries of tensors. :meth:`Decoder.init_params` draws
them from a numpy generator; JAX's threefry draws cannot be reproduced, so
parameters cross from the JAX package through ``repro_torch.convert``.

Candidate norms are summed over ``d`` in the fixed order ``0 .. d-1``, one
elementwise add per term (:func:`row_sum`), so a row's norm never depends
on how many rows it is computed with: a shard's prepared candidates are
bitwise the matching rows of the dense preparation on every device.

Rows of a relation table (and, in training, of the vertex states) are
gathered with ``kernels.ops.gather_rows``: the same values as
``table[ids]``, and a deterministic backward (``scatter_add_onehot``),
where advanced indexing's backward serialises over duplicate ids on CUDA
— a training batch repeats each relation thousands of times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.kge_score import EPILOGUES, apply_epilogue
from repro_torch.kernels.ops import gather_rows

Params = Dict[str, torch.Tensor]


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the fixed order ``0 .. d-1``. A reduction
    kernel may choose its summation order by shape; this keeps each row's
    sum the same bits whatever the leading shape."""
    acc = x[..., 0].clone()
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


# ====================================================================== #
# The Decoder protocol + registry
# ====================================================================== #
@dataclasses.dataclass(frozen=True)
class Decoder:
    """Base class: a registered scoring function in canonical query form.

    Subclasses define ``param_shapes`` / ``init_params`` /
    ``prepare_query`` / ``prepare_candidates`` and declare their
    ``epilogue`` family; ``score``, ``score_candidates`` and
    ``rank_scores`` are derived, so every path computes the same function.
    """

    name: str = ""
    epilogue: str = "bilinear"

    def __post_init__(self):
        if self.epilogue not in EPILOGUES:
            raise ValueError(f"unknown epilogue {self.epilogue!r}")

    # ---- per-decoder surface -------------------------------------------
    def param_shapes(self, num_relations: int,
                     dim: int) -> Dict[str, Tuple[int, ...]]:
        """Name → shape of every parameter (all fp32)."""
        raise NotImplementedError

    def init_params(self, rng: np.random.Generator, num_relations: int,
                    dim: int, device=None) -> Params:
        raise NotImplementedError

    def prepare_query(self, params: Params, h_s: torch.Tensor,
                      rel: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, d) heads + (B,) relation ids → query rows ``q`` (B, d) and
        pre-epilogue bias ``q_bias`` (B,)."""
        raise NotImplementedError

    def prepare_candidates(self, params: Params, candidates: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., d) candidate tails → ``(C', c_bias)``. Row-local, so
        per-shard candidate blocks prepare independently."""
        raise NotImplementedError

    # ---- derived: every path is the query form -------------------------
    def score(self, params: Params, h_s: torch.Tensor, rel: torch.Tensor,
              h_t: torch.Tensor) -> torch.Tensor:
        """(B,) triplet scores — the row-wise query form."""
        q, q_bias = self.prepare_query(params, h_s, rel)
        c, c_bias = self.prepare_candidates(params, h_t)
        return apply_epilogue(row_sum(q * c) + q_bias + c_bias,
                              self.epilogue)

    def score_candidates(self, params: Params, h_s: torch.Tensor,
                         rel: torch.Tensor, candidates: torch.Tensor,
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """(B, C) scores through a plain matrix product — the reference
        the kernel path is checked against."""
        q, q_bias = self.prepare_query(params, h_s, rel)
        c, c_bias = self.prepare_candidates(params, candidates)
        scores = apply_epilogue(
            q @ c.T + q_bias[:, None] + c_bias[None, :], self.epilogue)
        return scores if bias is None else scores + bias

    def rank_scores(self, params: Params, h_s: torch.Tensor,
                    rel: torch.Tensor, candidates: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    prepared: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                    ) -> torch.Tensor:
        """(B, C) scores through the ``kge_score`` kernel. ``prepared``
        skips ``prepare_candidates`` with a cached ``(C', c_bias)``."""
        from repro_torch.kernels.ops import kge_score_padded
        q, q_bias = self.prepare_query(params, h_s, rel)
        if prepared is None:
            prepared = self.prepare_candidates(params, candidates)
        c, c_bias = prepared
        return kge_score_padded(q, c, bias, q_bias, c_bias,
                                epilogue=self.epilogue)


_REGISTRY: Dict[str, Decoder] = {}


def register_decoder(decoder: Decoder) -> Decoder:
    """Add a Decoder singleton to the registry (idempotent per name)."""
    if not decoder.name:
        raise ValueError("decoder needs a name")
    _REGISTRY[decoder.name] = decoder
    return decoder


def get_decoder(decoder: Union[str, Decoder]) -> Decoder:
    """Resolve a decoder name or pass through an instance — the only
    string-to-decoder dispatch point."""
    if isinstance(decoder, Decoder):
        return decoder
    try:
        return _REGISTRY[decoder]
    except KeyError:
        raise ValueError(
            f"unknown decoder {decoder!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_decoders() -> Tuple[str, ...]:
    """Registered decoder names, sorted."""
    return tuple(sorted(_REGISTRY))


# ====================================================================== #
# The paper's decoders + RotatE
# ====================================================================== #
def _split_complex(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-half/second-half re/im convention of ComplEx and RotatE."""
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def _neg_l2_query(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Norm-expansion query: ``q = −2u``, ``q_bias = ‖u‖²``. A query batch
    is reduced with the same shape wherever it is scored, so one
    ``torch.sum`` per batch keeps its bits (``row_sum`` would launch
    ``d - 1`` adds per request step)."""
    return -2.0 * u, (u * u).sum(dim=-1)


def _zeros_bias(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def _normal_params(rng, name, shape, dim, device) -> Params:
    w = rng.standard_normal(shape) * (1.0 / np.sqrt(dim))
    return {name: torch.as_tensor(w.astype(np.float32), device=device)}


def _require_even(name: str, dim: int) -> None:
    if dim % 2:
        raise ValueError(f"{name} needs even dim")


@dataclasses.dataclass(frozen=True)
class DistMult(Decoder):
    """``g = h_s^T diag(m_r) h_t``."""

    name: str = "distmult"
    epilogue: str = "bilinear"

    def param_shapes(self, num_relations, dim):
        return {"rel_diag": (num_relations, dim)}

    def init_params(self, rng, num_relations, dim, device=None):
        return _normal_params(rng, "rel_diag", (num_relations, dim), dim,
                              device)

    def prepare_query(self, params, h_s, rel):
        q = h_s * gather_rows(params["rel_diag"], rel)
        return q, _zeros_bias(q)

    def prepare_candidates(self, params, candidates):
        return candidates, _zeros_bias(candidates)


@dataclasses.dataclass(frozen=True)
class TransE(Decoder):
    """``g = −‖h_s + r − h_t‖₂`` via the norm expansion (eps under the
    sqrt)."""

    name: str = "transe"
    epilogue: str = "neg_l2"

    def param_shapes(self, num_relations, dim):
        return {"rel_vec": (num_relations, dim)}

    def init_params(self, rng, num_relations, dim, device=None):
        return _normal_params(rng, "rel_vec", (num_relations, dim), dim,
                              device)

    def prepare_query(self, params, h_s, rel):
        return _neg_l2_query(
            h_s + gather_rows(params["rel_vec"], rel))

    def prepare_candidates(self, params, candidates):
        return candidates, row_sum(candidates * candidates)


@dataclasses.dataclass(frozen=True)
class ComplEx(Decoder):
    """``g = Re(<h_s, r, conj(h_t)>)``: the relation-rotated query
    ``q = (s_r r_r − s_i r_i, s_r r_i + s_i r_r)`` against untouched
    candidates."""

    name: str = "complex"
    epilogue: str = "bilinear"

    def param_shapes(self, num_relations, dim):
        _require_even("ComplEx", dim)
        return {"rel_complex": (num_relations, dim)}

    def init_params(self, rng, num_relations, dim, device=None):
        _require_even("ComplEx", dim)
        return _normal_params(rng, "rel_complex", (num_relations, dim), dim,
                              device)

    def prepare_query(self, params, h_s, rel):
        sr, si = _split_complex(h_s)
        rr, ri = _split_complex(
            gather_rows(params["rel_complex"], rel))
        q = torch.cat([sr * rr - si * ri, sr * ri + si * rr], dim=-1)
        return q, _zeros_bias(q)

    def prepare_candidates(self, params, candidates):
        return candidates, _zeros_bias(candidates)


@dataclasses.dataclass(frozen=True)
class RotatE(Decoder):
    """``g = −‖h_s ∘ r − h_t‖₂`` with unit-modulus relations
    ``r = e^{iθ_r}``; the rotated head is the query of the TransE norm
    expansion."""

    name: str = "rotate"
    epilogue: str = "neg_l2"

    def param_shapes(self, num_relations, dim):
        _require_even("RotatE", dim)
        return {"rel_phase": (num_relations, dim // 2)}

    def init_params(self, rng, num_relations, dim, device=None):
        _require_even("RotatE", dim)
        phase = rng.uniform(-np.pi, np.pi, (num_relations, dim // 2))
        return {"rel_phase": torch.as_tensor(phase.astype(np.float32),
                                             device=device)}

    def prepare_query(self, params, h_s, rel):
        hr, hi = _split_complex(h_s)
        theta = gather_rows(params["rel_phase"], rel)
        cos, sin = torch.cos(theta), torch.sin(theta)
        u = torch.cat([hr * cos - hi * sin, hr * sin + hi * cos], dim=-1)
        return _neg_l2_query(u)

    def prepare_candidates(self, params, candidates):
        return candidates, row_sum(candidates * candidates)


DISTMULT = register_decoder(DistMult())
TRANSE = register_decoder(TransE())
COMPLEX = register_decoder(ComplEx())
ROTATE = register_decoder(RotatE())


# ====================================================================== #
# Functional conveniences (all registry-resolved)
# ====================================================================== #
def init_decoder_params(rng: np.random.Generator,
                        decoder: Union[str, Decoder], num_relations: int,
                        dim: int, device=None) -> Params:
    return get_decoder(decoder).init_params(rng, num_relations, dim, device)


def score_against_candidates(
    params: Params, decoder: Union[str, Decoder], h_s: torch.Tensor,
    rel: torch.Tensor, candidates: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rank-evaluation form: (B, d) heads × (C, d) candidate tails →
    (B, C) through a plain matrix product. The kernel twin is
    ``Decoder.rank_scores``."""
    return get_decoder(decoder).score_candidates(params, h_s, rel,
                                                 candidates, bias)


def score_triplets(params: Params, decoder: Union[str, Decoder],
                   h: torch.Tensor, triplets: torch.Tensor) -> torch.Tensor:
    """Score ``(T, 3)`` batch-local triplets against vertex states
    ``h (V, d)`` → ``(T,)``: the query form of :meth:`Decoder.score`, with
    the dot product as one ``torch.sum`` — training needs no fixed
    summation order, and ``row_sum``'s backward writes a full ``(T, d)``
    gradient per column."""
    dec = get_decoder(decoder)
    trip = triplets.contiguous()
    q, q_bias = dec.prepare_query(
        params, gather_rows(h, trip[:, 0]), trip[:, 1])
    c, c_bias = dec.prepare_candidates(
        params, gather_rows(h, trip[:, 2]))
    return apply_epilogue((q * c).sum(dim=-1) + q_bias + c_bias,
                          dec.epilogue)


def bce_loss(scores: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 3: mean binary cross-entropy over positives and
    negatives, in the numerically stable logits form, padding masked
    out."""
    per = torch.clamp_min(scores, 0) - scores * labels + \
        torch.log1p(torch.exp(-torch.abs(scores)))
    return torch.sum(per * mask) / torch.clamp_min(mask.sum(), 1.0)
