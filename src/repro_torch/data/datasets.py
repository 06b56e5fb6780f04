"""KG dataset loading, synthetic benchmark graphs and the LM token stream
(port of ``repro/data/datasets.py``).

* FB15k-237-format loader: ``train.txt``/``valid.txt``/``test.txt`` TSV of
  ``head<TAB>relation<TAB>tail`` surface forms (the standard distribution
  format); builds entity/relation vocabularies from the train split.
* ``synthetic_fb15k`` / ``synthetic_citation2`` — offline stand-ins with the
  same *shape characteristics* (relation count, skew, feature presence) at
  reduced scale, drawn with the reference's numpy calls so the same seed
  gives the same splits; real files drop in transparently.
* ``TokenStream`` — deterministic synthetic LM batches, the reference's
  numpy draws.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.graph import KnowledgeGraph, make_synthetic_kg, \
    split_train_valid_test


def load_fb15k_format(directory: str) -> Dict[str, KnowledgeGraph]:
    """Load a directory of {train,valid,test}.txt triplet TSVs."""
    vocabs: Dict[str, Dict[str, int]] = {"ent": {}, "rel": {}}

    def intern(table: Dict[str, int], key: str) -> int:
        if key not in table:
            table[key] = len(table)
        return table[key]

    raw: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for split in ("train", "valid", "test"):
        path = os.path.join(directory, f"{split}.txt")
        src, rel, dst = [], [], []
        with open(path) as f:
            for line in f:
                h, r, t = line.rstrip("\n").split("\t")
                src.append(intern(vocabs["ent"], h))
                rel.append(intern(vocabs["rel"], r))
                dst.append(intern(vocabs["ent"], t))
        raw[split] = (np.array(src, np.int32), np.array(rel, np.int32),
                      np.array(dst, np.int32))

    n_ent = len(vocabs["ent"])
    n_rel = len(vocabs["rel"])
    return {
        split: KnowledgeGraph(
            src=s, rel=r, dst=d, num_entities=n_ent, num_relations=n_rel)
        for split, (s, r, d) in raw.items()
    }


def synthetic_fb15k(scale: float = 0.05, seed: int = 0
                    ) -> Dict[str, KnowledgeGraph]:
    """FB15k-237-shaped synthetic KG: many relation types, no features,
    transductive (learned entity embeddings)."""
    n_ent = max(200, int(14541 * scale))
    n_rel = max(8, int(237 * scale))
    n_edge = max(2000, int(272115 * scale))
    kg = make_synthetic_kg(n_ent, n_rel, n_edge, seed=seed)
    return split_train_valid_test(kg, 0.06, 0.07, seed=seed)


def synthetic_citation2(scale: float = 0.002, seed: int = 0
                        ) -> Dict[str, KnowledgeGraph]:
    """ogbl-citation2-shaped synthetic KG: single relation, 128-d features."""
    n_ent = max(500, int(2_927_963 * scale))
    n_edge = max(4000, int(30_387_995 * scale))
    kg = make_synthetic_kg(n_ent, 1, n_edge, seed=seed, feature_dim=128)
    return split_train_valid_test(kg, 0.003, 0.003, seed=seed)


def load_or_synthesize(name: str, data_root: Optional[str] = None,
                       **kw) -> Dict[str, KnowledgeGraph]:
    """Use real data when present under ``data_root/<name>``, else the
    synthetic stand-in."""
    if data_root:
        path = os.path.join(data_root, name)
        if os.path.isdir(path):
            return load_fb15k_format(path)
    if name == "fb15k-237":
        return synthetic_fb15k(**kw)
    if name == "ogbl-citation2":
        return synthetic_citation2(**kw)
    raise ValueError(f"unknown dataset {name!r}")


class TokenStream:
    """Deterministic synthetic LM token batches: the reference's numpy
    draws in its order, so a seed gives the reference's batches. Each is
    ``{"tokens", "labels"}``, ``(batch_size, seq_len)`` int32, the labels
    the tokens shifted by one."""

    def __init__(self, vocab_size: int, batch_size: int, seq_len: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        # a Markov-ish stream, so the loss has structure to learn: every
        # odd position follows from the even one before it
        base = self._rng.integers(
            0, self.vocab_size, (self.batch_size, self.seq_len + 1))
        base[:, 1::2] = (base[:, 0::2][:, : base[:, 1::2].shape[1]]
                         * 31 + 7) % self.vocab_size
        return {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }
