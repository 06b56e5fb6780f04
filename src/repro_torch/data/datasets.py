"""KG dataset loading + synthetic benchmark graphs (port of
``repro/data/datasets.py``; the LM token stream is not ported).

* FB15k-237-format loader: ``train.txt``/``valid.txt``/``test.txt`` TSV of
  ``head<TAB>relation<TAB>tail`` surface forms (the standard distribution
  format); builds entity/relation vocabularies from the train split.
* ``synthetic_fb15k`` / ``synthetic_citation2`` — offline stand-ins with the
  same *shape characteristics* (relation count, skew, feature presence) at
  reduced scale, drawn with the reference's numpy calls so the same seed
  gives the same splits; real files drop in transparently.
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
