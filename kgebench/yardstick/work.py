"""The work a kernel call or a step needs, from its shapes: operations and
bytes, counted the way a roofline counts them (each input byte read once,
each output byte written once, whatever an implementation reads again).

The kernels' formulas are frozen copies of the ones the port keeps beside
its kernels (``kernels/rgcn_message.py``, ``kernels/kge_score.py``,
``kernels/topk.py``), so a later change of the program cannot move the
yardstick. The step counts are the benchmark's own.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple


def basis_message_ops(e: int, nb: int, d_in: int, d_out: int,
                      n_on: Optional[int] = None) -> int:
    """A ``d_in -> d_out`` product and its coefficient for each of ``nb``
    bases, on the ``n_on`` edges that are on (every edge when not
    given)."""
    return 2 * (e if n_on is None else n_on) * nb * d_out * (d_in + 1)


def basis_message_bytes(e: int, nb: int, d_in: int, d_out: int) -> int:
    """fp32 edge inputs and coefficients, the bases and the bool mask read,
    the messages written."""
    return 4 * (e * d_in + e * nb + nb * d_in * d_out + e * d_out) + e


def kge_score_ops(b: int, c: int, d: int) -> int:
    """The ``(B, d) x (d, C)`` product."""
    return 2 * b * c * d


def kge_score_bytes(b: int, c: int, d: int, filtered: bool = False) -> int:
    """fp32 q, the candidates and both bias vectors read, the ``(B, C)``
    scores written; a filtered query also reads its ``(B, C)`` bias of
    known tails. An unfiltered query needs no per-row bias: a block that
    an implementation reads anyway is not counted."""
    return 4 * (b * d + c * d + b + c + b * c) + (4 * b * c if filtered
                                                  else 0)


def topk_scores_ops(b: int, c: int) -> int:
    """One comparison a score."""
    return b * c


def topk_scores_bytes(b: int, c: int, k: int, with_ids: bool = False) -> int:
    """The fp32 scores read, k fp32 values and int64 indices a row
    written; with ``ids`` (the merge of shards' winners) their int64 ids
    read too."""
    return 4 * b * c + 12 * b * k + (8 * b * k if with_ids else 0)


def rgcn_layer_forward_ops(n_on: int, v: int, nb: int, d_in: int,
                           d_out: int) -> int:
    """One RGCN layer on ``n_on`` edges into ``v`` vertices: the basis
    messages, their sum into each vertex and the mean's division, the
    self-loop product and its add."""
    return (basis_message_ops(n_on, nb, d_in, d_out)
            + n_on * d_out + v * d_out
            + 2 * v * d_in * d_out + v * d_out)


def distmult_forward_ops(triplets: int, d: int) -> int:
    """``sum(h_s * m_r * h_t)`` for each triplet: two products and an add
    a dimension."""
    return 3 * triplets * d


def kge_train_step_ops(trainers: Iterable[Tuple[int, int, int]],
                       layer_dims: Iterable[Tuple[int, int]], nb: int,
                       d: int, negatives: int) -> int:
    """Operations of one data-parallel step: for each trainer's ``(n_on
    edges, v real vertices, c core edges)``, every layer's forward and
    DistMult over the core edges and their negatives; the backward of a
    product takes twice its forward, so the step is three forwards (no
    recomputation). Elementwise work (activations, dropout, the loss) is
    not counted."""
    layer_dims = list(layer_dims)
    forward = 0
    for n_on, v, c in trainers:
        forward += sum(rgcn_layer_forward_ops(n_on, v, nb, d_in, d_out)
                       for d_in, d_out in layer_dims)
        forward += distmult_forward_ops(c * (1 + negatives), d)
    return 3 * forward


def serve_step_ops(queries: int, entities: int, d: int) -> int:
    """Operations of answering ``queries`` DistMult queries over every
    entity: the query form ``h * m_r``, then one product with each
    candidate."""
    return queries * d + kge_score_ops(queries, entities, d)
