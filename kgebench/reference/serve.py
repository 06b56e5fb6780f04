"""The plain answer to a ``(head, relation, ?)`` query under DistMult:
every entity scored as ``sum(e_h * m_r * e_t)`` by one matrix product in
float32 (TF32 off, or on for the precision control), then the k best,
descending. Plain PyTorch; it imports nothing of the program."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kgebench.reference.train import matmul_precision


def scores(table: torch.Tensor, rel_diag: torch.Tensor, heads: np.ndarray,
           rels: np.ndarray, tf32: bool = False) -> torch.Tensor:
    """``(len(heads), N)`` scores of the queries."""
    h = torch.from_numpy(np.asarray(heads, np.int64)).to(table.device)
    r = torch.from_numpy(np.asarray(rels, np.int64)).to(table.device)
    with matmul_precision(tf32):
        return (table[h] * rel_diag[r]) @ table.T


def topk(table: torch.Tensor, rel_diag: torch.Tensor, heads: np.ndarray,
         rels: np.ndarray, k: int, block: int = 128, tf32: bool = False
         ) -> Tuple[np.ndarray, np.ndarray]:
    """``(values (n, k), ids (n, k))`` of the queries, ``block`` queries
    at a time (a block's ``(block, N)`` scores exist at once)."""
    vals, ids = [], []
    for lo in range(0, len(heads), block):
        s = scores(table, rel_diag, heads[lo:lo + block],
                   rels[lo:lo + block], tf32)
        v, i = torch.topk(s, k, dim=1)
        vals.append(v.cpu().numpy())
        ids.append(i.cpu().numpy())
    return np.concatenate(vals), np.concatenate(ids)


def scores_at(table: torch.Tensor, rel_diag: torch.Tensor,
              heads: np.ndarray, rels: np.ndarray, ids: np.ndarray
              ) -> np.ndarray:
    """``(n, k)`` float32 scores of each query's ``ids`` (the served
    tails), each a plain sum over the dimensions in float64 of the float32
    products, so a served value is judged against its exact score."""
    dev = table.device
    h = torch.from_numpy(np.asarray(heads, np.int64)).to(dev)
    r = torch.from_numpy(np.asarray(rels, np.int64)).to(dev)
    t = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    q = (table[h] * rel_diag[r]).double()
    return (q[:, None, :] * table[t].double()).sum(-1).cpu().numpy()
