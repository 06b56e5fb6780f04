"""The PyTorch port's host graph side (``repro_torch.core``,
``repro_torch.data``, ``repro_torch.training.preprocessing``) against the
JAX package's, on the CPU.

Everything here is host numpy in both packages, drawn from the same seeds
with the same calls, so every array must be ``np.array_equal`` to the
reference's. The negative samplers draw on the device from a
``torch.Generator`` (the reference uses threefry), so they are held to
their contract instead: shapes, ranges, one corrupted side per negative.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import expansion as j_expansion
from repro.core import graph as j_graph
from repro.core import partition as j_partition
from repro.data import datasets as j_datasets
from repro.training.preprocessing import preprocess_graph as j_preprocess
from repro_torch.core import expansion, graph, negative, partition
from repro_torch.data import datasets
from repro_torch.training.preprocessing import preprocess_graph


def both_kgs(n=300, r=10, e=2500, seed=7, feature_dim=None):
    kw = dict(seed=seed, feature_dim=feature_dim)
    return (graph.make_synthetic_kg(n, r, e, **kw).with_inverse_relations(),
            j_graph.make_synthetic_kg(n, r, e, **kw).with_inverse_relations())


def assert_kg_equal(a, b):
    for f in ("src", "rel", "dst"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert (a.num_entities, a.num_relations) == \
        (b.num_entities, b.num_relations)
    if b.features is None:
        assert a.features is None
    else:
        np.testing.assert_array_equal(a.features, b.features)


def assert_fields_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("feature_dim", [None, 6])
def test_synthetic_kg_and_adjacency_equal_reference(feature_dim):
    kg, jkg = both_kgs(feature_dim=feature_dim)
    assert_kg_equal(kg, jkg)
    np.testing.assert_array_equal(kg.degrees(), jkg.degrees())
    verts = np.array([0, 3, 17, 250])
    np.testing.assert_array_equal(kg.in_edges(verts), jkg.in_edges(verts))
    np.testing.assert_array_equal(kg.incident_edges(verts),
                                  jkg.incident_edges(verts))
    assert kg.incident_edges(np.zeros(0, np.int64)).size == 0
    ids = np.array([5, 1, 99])
    assert_kg_equal(kg.subgraph(ids), jkg.subgraph(ids))
    assert graph.triplet_set(kg) == j_graph.triplet_set(jkg)
    for a, b in zip(graph.split_train_valid_test(kg, seed=2).values(),
                    j_graph.split_train_valid_test(jkg, seed=2).values()):
        assert_kg_equal(a, b)


@pytest.mark.parametrize("strategy", ["vertex_cut", "edge_cut", "random"])
@pytest.mark.parametrize("num_parts", [1, 3, 4])
def test_partition_graph_equals_reference(strategy, num_parts):
    kg, jkg = both_kgs()
    parts = partition.partition_graph(kg, num_parts, strategy, seed=1)
    jparts = j_partition.partition_graph(jkg, num_parts, strategy, seed=1)
    assert len(parts) == len(jparts) == num_parts
    for p, jp in zip(parts, jparts):
        np.testing.assert_array_equal(p.core_edge_ids, jp.core_edge_ids)
        assert p.core_edge_ids.dtype == jp.core_edge_ids.dtype
    assert partition.replication_factor(kg, parts) == \
        j_partition.replication_factor(jkg, jparts)
    assert partition.load_balance(parts) == j_partition.load_balance(jparts)


def test_unknown_strategy_raises():
    kg, _ = both_kgs()
    with pytest.raises(ValueError):
        partition.partition_graph(kg, 2, "metis")


@pytest.mark.parametrize("num_hops", [1, 2])
def test_expand_and_pad_equal_reference(num_hops):
    kg, jkg = both_kgs()
    parts = partition.partition_graph(kg, 4, "vertex_cut", seed=0)
    jparts = j_partition.partition_graph(jkg, 4, "vertex_cut", seed=0)
    exp = expansion.expand_all(kg, parts, num_hops)
    jexp = j_expansion.expand_all(jkg, jparts, num_hops)
    for p, jp in zip(exp, jexp):
        assert_fields_equal(p, jp)
        assert expansion.verify_self_sufficiency(kg, p)
    assert_fields_equal(expansion.pad_partitions(exp),
                        j_expansion.pad_partitions(jexp))
    assert_fields_equal(
        expansion.pad_partitions(exp, max_vertices=333, max_edges=5000),
        j_expansion.pad_partitions(jexp, max_vertices=333, max_edges=5000))
    pad = expansion.pad_partitions(exp)
    assert pad.padding_waste() == j_expansion.pad_partitions(
        jexp).padding_waste()


@pytest.mark.parametrize("scale,seed", [(0.01, 3), (0.03, 0)])
def test_synthetic_fb15k_splits_equal_reference(scale, seed):
    ours = datasets.synthetic_fb15k(scale=scale, seed=seed)
    ref = j_datasets.synthetic_fb15k(scale=scale, seed=seed)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert_kg_equal(ours[k], ref[k])


def test_synthetic_citation2_and_loaders_equal_reference(tmp_path):
    ours = datasets.synthetic_citation2(scale=0.0002, seed=1)
    ref = j_datasets.synthetic_citation2(scale=0.0002, seed=1)
    for k in ref:
        assert_kg_equal(ours[k], ref[k])
    rng = np.random.default_rng(0)
    root = tmp_path / "fb15k-237"
    root.mkdir()
    for split in ("train", "valid", "test"):
        with open(root / f"{split}.txt", "w") as f:
            for _ in range(40):
                h, r, t = rng.integers(0, 30, 3)
                f.write(f"/m/e{h}\t/r/{r % 5}\t/m/e{t}\n")
    a = datasets.load_or_synthesize("fb15k-237", data_root=str(tmp_path))
    b = j_datasets.load_or_synthesize("fb15k-237", data_root=str(tmp_path))
    for k in b:
        assert_kg_equal(a[k], b[k])
    assert_kg_equal(datasets.load_or_synthesize("fb15k-237",
                                                scale=0.01)["test"],
                    j_datasets.load_or_synthesize("fb15k-237",
                                                  scale=0.01)["test"])
    with pytest.raises(ValueError):
        datasets.load_or_synthesize("wn18rr")
    assert not os.path.exists(tmp_path / "ogbl-citation2")


@pytest.mark.parametrize("num_trainers,strategy",
                         [(2, "vertex_cut"), (4, "vertex_cut"),
                          (3, "random")])
def test_preprocess_graph_equals_reference(num_trainers, strategy):
    splits = datasets.synthetic_fb15k(scale=0.01, seed=3)
    jsplits = j_datasets.synthetic_fb15k(scale=0.01, seed=3)
    kg = splits["train"].with_inverse_relations()
    jkg = jsplits["train"].with_inverse_relations()
    pre = preprocess_graph(kg, num_trainers=num_trainers, strategy=strategy,
                           num_hops=2, seed=0)
    jpre = j_preprocess(jkg, num_trainers=num_trainers, strategy=strategy,
                        num_hops=2, seed=0)
    assert pre.num_partitions == jpre.num_partitions
    assert pre.replication_factor == jpre.replication_factor
    assert_fields_equal(pre.padded, jpre.padded)
    for p, jp in zip(pre.partitions, jpre.partitions):
        assert_fields_equal(p, jp)


def _triplets(rng, b, v):
    return torch.from_numpy(np.stack([rng.integers(0, v, b),
                                      rng.integers(0, 7, b),
                                      rng.integers(0, v, b)], 1))


@pytest.mark.parametrize("num_negatives", [1, 3])
def test_corrupt_triplets_contract(num_negatives):
    rng = np.random.default_rng(0)
    pos = _triplets(rng, 500, 40)
    gen = torch.Generator().manual_seed(5)
    neg, head = negative.constraint_based_negatives(gen, pos, num_negatives,
                                                    11)
    b, s = pos.shape[0], num_negatives
    assert neg.shape == (b * s, 3) and head.shape == (b * s,)
    assert neg.dtype == pos.dtype and head.dtype == torch.bool
    rep = pos.repeat_interleave(s, dim=0)
    assert torch.equal(neg[:, 1], rep[:, 1])                 # relation kept
    assert torch.equal(neg[head, 2], rep[head, 2])           # tail kept
    assert torch.equal(neg[~head, 0], rep[~head, 0])         # head kept
    drawn = torch.where(head, neg[:, 0], neg[:, 2])
    assert int(drawn.min()) >= 0 and int(drawn.max()) < 11
    assert 0.4 < float(head.float().mean()) < 0.6
    again, _ = negative.corrupt_triplets(torch.Generator().manual_seed(5),
                                         pos, num_negatives, 11)
    assert torch.equal(neg, again)                           # reproducible
    glob, _ = negative.global_closed_world_negatives(
        torch.Generator().manual_seed(6), pos, num_negatives, 40)
    assert int(torch.where(head, glob[:, 0], glob[:, 2]).max()) < 40
    trip, labels = negative.mix_pos_neg(pos, neg)
    assert trip.shape == (b * (s + 1), 3)
    assert labels.dtype == torch.float32
    assert float(labels[:b].min()) == 1.0 and float(labels[b:].max()) == 0.0


def test_corrupt_triplets_limit_zero_draws_zero():
    pos = _triplets(np.random.default_rng(1), 20, 5)
    neg, head = negative.corrupt_triplets(torch.Generator().manual_seed(0),
                                          pos, 2, 0)
    assert int(torch.where(head, neg[:, 0], neg[:, 2]).max()) == 0
