"""The port's edge mini-batch training (``repro_torch.core.minibatch``,
``models.kge.minibatch_loss``, the mini-batch ``KGETrainer``) against the
JAX package's, on the CPU.

* Host arrays — epoch negatives, comp graphs, budgets, batches, the
  preprocessing artifacts — are ``np.array_equal`` to the reference's on
  the same seeds.
* ``minibatch_loss`` and its gradients at 1, 2 and 4 table shards are
  bitwise equal to each other (and with a deduplicated plan), and within
  ``rtol=1e-3, atol=1e-4`` of JAX's from the same weights, dropout off.
* Trainer level: the table's shard count, plan dedup, the exchange layout
  and the pipeline kind never change the loss trajectory (``==``); from
  the reference's initial parameters at dropout 0 the trajectory is
  within ``rtol=1e-3, atol=1e-4`` of ``repro.KGETrainer``'s (its batches
  are the same host draws, so nothing random differs).
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import expand_all as j_expand_all
from repro.core import make_synthetic_kg as j_make_synthetic_kg
from repro.core import minibatch as jmb
from repro.core import partition_graph as j_partition_graph
from repro.data import synthetic_fb15k as j_synthetic_fb15k
from repro.data.pipeline import SerialMinibatchPipeline as JSerial
from repro.models.kge import KGEConfig as JKGEConfig
from repro.models.kge import init_kge_params as j_init_kge_params
from repro.models.kge import minibatch_loss as j_minibatch_loss
from repro.models.rgcn import RGCNConfig as JRGCNConfig
from repro.sharding.embedding import ShardedTableLayout as JLayout
from repro.training import KGETrainer as JKGETrainer
from repro.training import TrainConfig as JTrainConfig
from repro.training.preprocessing import preprocess_graph as j_preprocess
from repro_torch import convert
from repro_torch.core import expand_all, make_synthetic_kg, partition_graph
from repro_torch.core import minibatch as mb
from repro_torch.data import synthetic_fb15k
from repro_torch.data.pipeline import SerialMinibatchPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models.kge import KGEConfig, minibatch_loss
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.sharding import ShardedTableLayout, unshard_table
from repro_torch.training import KGETrainer, TrainConfig
from repro_torch.training.preprocessing import preprocess_graph

LOSS_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def graphs():
    kg = make_synthetic_kg(300, 10, 2500, seed=7).with_inverse_relations()
    jkg = j_make_synthetic_kg(300, 10, 2500, seed=7).with_inverse_relations()
    parts = expand_all(kg, partition_graph(kg, 2, "vertex_cut", seed=0), 2)
    jparts = j_expand_all(jkg, j_partition_graph(jkg, 2, "vertex_cut",
                                                 seed=0), 2)
    return kg, jkg, parts, jparts


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


# ---------------------------------------------------------------------- #
# Host arrays
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sampler", ["constraint", "global"])
def test_epoch_negatives_equal_reference(graphs, sampler):
    _, _, parts, jparts = graphs
    for p, jp in zip(parts, jparts):
        got = mb.sample_epoch_negatives(np.random.default_rng(4), p, 2,
                                        sampler)
        want = jmb.sample_epoch_negatives(np.random.default_rng(4), jp, 2,
                                          sampler)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown negative sampler"):
        mb.sample_epoch_negatives(np.random.default_rng(0), parts[0], 1,
                                  "nearby")


def test_comp_graphs_equal_reference(graphs):
    _, _, parts, jparts = graphs
    rng = np.random.default_rng(1)
    for p, jp in zip(parts, jparts):
        seeds = rng.integers(0, p.num_core_vertices, 20)
        for hops in (1, 2):
            got = mb.build_comp_graph(p, seeds, hops)
            want = jmb.build_comp_graph(jp, seeds, hops)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
        csr, jcsr = mb._PartitionCSR(p), jmb._PartitionCSR(jp)
        assert np.array_equal(csr.indptr, jcsr.indptr)
        assert np.array_equal(csr.in_edges_of(seeds),
                              jcsr.in_edges_of(seeds))


@pytest.mark.parametrize("sampler", ["constraint", "global"])
def test_budgets_and_batches_equal_reference(graphs, sampler):
    _, _, parts, jparts = graphs
    budget = mb.plan_budgets(parts, 40, 2, 2, seed=3, sampler=sampler)
    jbudget = jmb.plan_budgets(jparts, 40, 2, 2, seed=3, sampler=sampler)
    assert dataclasses.asdict(budget) == dataclasses.asdict(jbudget)
    got = list(mb.iterate_edge_minibatches(
        np.random.default_rng(8), parts[1], 40, 2, 2, budget,
        sampler=sampler))
    want = list(jmb.iterate_edge_minibatches(
        np.random.default_rng(8), jparts[1], 40, 2, 2, jbudget,
        sampler=sampler))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _fields_equal(g, w)
    _fields_equal(mb.stack_minibatches(got[:2]),
                  jmb.stack_minibatches(want[:2]))
    with pytest.raises(ValueError, match="exceeds budget"):
        mb.build_edge_minibatch(parts[1], got[0].triplets[:4],
                                got[0].labels[:4], 2, 1, 1, 8)


def test_preprocessing_artifacts_equal_reference():
    splits = synthetic_fb15k(scale=0.01, seed=3)
    jsplits = j_synthetic_fb15k(scale=0.01, seed=3)
    kw = dict(num_trainers=2, batch_size=64, num_table_shards=4, seed=0)
    pre = preprocess_graph(splits["train"].with_inverse_relations(), **kw)
    jpre = j_preprocess(jsplits["train"].with_inverse_relations(), **kw)
    assert dataclasses.asdict(pre.budget) == dataclasses.asdict(jpre.budget)
    assert (pre.table_layout.num_rows, pre.table_layout.num_shards) == \
        (jpre.table_layout.num_rows, jpre.table_layout.num_shards)
    for c, jc in zip(pre.csrs, jpre.csrs):
        assert np.array_equal(c.sorted_eids, jc.sorted_eids)
        assert np.array_equal(c.indptr, jc.indptr)
    dense = preprocess_graph(splits["train"].with_inverse_relations(),
                             num_trainers=2)
    assert dense.budget is None and dense.csrs is None
    assert dense.table_layout is None


# ---------------------------------------------------------------------- #
# minibatch_loss
# ---------------------------------------------------------------------- #
def _first_batch(parts, kg, s, dedup=False, port=True):
    budget = mb.plan_budgets(parts, 32, 1, 2, seed=0)
    if port:
        layout = ShardedTableLayout(kg.num_entities, s) if s > 1 else None
        pipe = SerialMinibatchPipeline(
            parts, batch_size=32, num_negatives=1, num_hops=2,
            budget=budget, seed=5, table_layout=layout, dedup_gather=dedup)
        batch = next(iter(pipe.device_batches(1)))
        return {k: v[0] for k, v in batch.items()}
    layout = JLayout(kg.num_entities, s) if s > 1 else None
    pipe = JSerial(parts, batch_size=32, num_negatives=1, num_hops=2,
                   budget=budget, seed=5, table_layout=layout)
    batch = next(iter(pipe.device_batches(1)))
    return jax.tree_util.tree_map(lambda x: x[0], batch)


def _port_loss_grads(params, cfg, batch):
    loss, aux = minibatch_loss(params, cfg, batch)
    names, ps = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    out = {}
    for n, g in zip(names, grads):
        if n == "entity_embedding" and g.dim() == 3:
            g = unshard_table(g, cfg.num_entities)
        out[n] = g
    return loss, aux, out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_minibatch_loss_bitwise_across_shards_and_near_reference(
        graphs, use_kernel):
    kg, jkg, parts, jparts = graphs
    rgcn = dict(num_entities=kg.num_entities,
                num_relations=kg.num_relations, hidden_dim=16, dropout=0.0,
                use_kernel=use_kernel)
    jcfg = JKGEConfig(JRGCNConfig(**rgcn))
    jparams = j_init_kge_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = _first_batch(jparts, jkg, 1, port=False)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_minibatch_loss(p, jcfg, jbatch), has_aux=True)(jparams)
    jflat = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    runs = {}
    for s, dedup in ((1, False), (2, False), (4, False), (4, True)):
        cfg = KGEConfig(RGCNConfig(**rgcn, num_table_shards=s))
        t = dict(tree)
        if s > 1:
            from repro.sharding.embedding import shard_table as j_shard
            t["entity_embedding"] = np.asarray(j_shard(
                tree["entity_embedding"], JLayout(kg.num_entities, s)))
        params = convert.kge_model_from_jax(t, cfg, device="cpu")
        batch = _first_batch(parts, kg, s, dedup)
        runs[(s, dedup)] = _port_loss_grads(params, cfg, batch)
    loss1, aux1, grads1 = runs[(1, False)]
    for key, (loss, aux, grads) in runs.items():
        assert loss.item() == loss1.item(), key
        assert set(aux) == {"loss", "pos_score_mean", "neg_score_mean"}
        for n in grads1:
            assert torch.equal(grads[n], grads1[n]), (key, n)
    np.testing.assert_allclose(loss1.item(), float(jloss), **LOSS_TOL)
    for n, g in grads1.items():
        np.testing.assert_allclose(g.numpy(), jflat[n], err_msg=n,
                                   **LOSS_TOL)


# ---------------------------------------------------------------------- #
# Trainer level
# ---------------------------------------------------------------------- #
MB = dict(num_trainers=2, epochs=2, hidden_dim=16, batch_size=64,
          num_negatives=1, learning_rate=0.01, seed=0)


@pytest.fixture(scope="module")
def splits():
    return synthetic_fb15k(scale=0.01, seed=3)


def _fit(splits, **kw):
    tr = KGETrainer(splits, TrainConfig(**{**MB, **kw}), device="cpu")
    hist = tr.fit()
    tr.close()
    return tr, [h["losses"] for h in hist]


@pytest.fixture(scope="module")
def base_run(splits):
    return _fit(splits, num_table_shards=2)


@pytest.mark.parametrize("variant", [
    dict(num_table_shards=1), dict(num_table_shards=2, gather_dedup=True),
    dict(num_table_shards=2, gather_exchange="masked_sum"),
    dict(num_table_shards=2, pipeline="serial")])
def test_trainer_variants_give_identical_losses(splits, base_run, variant):
    tr0, losses0 = base_run
    tr, losses = _fit(splits, **variant)
    assert losses == losses0
    assert sum(len(x) for x in losses) > 4
    table0 = tr0.params.entity_embedding.detach()
    table = tr.params.entity_embedding.detach()
    if table.dim() == 2:
        table0 = unshard_table(table0, table.shape[0])
    assert torch.equal(table, table0)
    for (n, a), (_, b) in zip(list(tr.params.named_parameters())[1:],
                              list(tr0.params.named_parameters())[1:]):
        assert torch.equal(a, b), n


def test_trainer_sharded_evaluation_equals_dense(splits, base_run):
    tr, _ = base_run
    emb = tr.encode_all_entities()
    assert emb.shape == (tr.train_kg.num_entities, 16)
    sharded = tr.evaluate("valid")
    dense_cfg = dataclasses.replace(tr.kge_cfg, rgcn=dataclasses.replace(
        tr.kge_cfg.rgcn, num_table_shards=1))
    from repro_torch.training.evaluation import evaluate_split
    dense_params = convert.kge_model_from_jax(
        {**convert.kge_model_to_jax(tr.params),
         "entity_embedding": unshard_table(
             tr.params.entity_embedding.detach(),
             tr.train_kg.num_entities).numpy()}, dense_cfg, device="cpu")
    dense = evaluate_split(dense_params, dense_cfg, tr.splits, "valid", 2,
                           "distmult", partitions=tr.partitions,
                           padded=tr.padded)
    assert sharded == dense


def test_trainer_trajectory_near_reference(splits):
    jsplits = j_synthetic_fb15k(scale=0.01, seed=3)
    kw = dict(MB, dropout=0.0, num_table_shards=2)
    jtr = JKGETrainer(jsplits, JTrainConfig(**kw))
    tr = KGETrainer(splits, TrainConfig(**kw), device="cpu")
    tr.params = convert.kge_model_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params), tr.kge_cfg,
        device="cpu")
    tr.opt_state = tr.optimizer.init(
        {n: p.detach() for n, p in tr.params.named_parameters()})
    hist, jhist = tr.fit(), jtr.fit()
    tr.close()
    jtr.close()
    assert [h["num_batches"] for h in hist] == \
        [h["num_batches"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], **LOSS_TOL)
    want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                       jtr.params))
    for name, p in tr.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **LOSS_TOL)


def test_int8_trainer_trajectory_near_reference(splits):
    """``table_dtype="int8"`` mini-batch training (batch 64, 2 table
    shards): with and without plan dedup the port's per-step losses and
    final parameters are bitwise equal, and within ``rtol=1e-3,
    atol=1e-4`` of ``repro.KGETrainer(table_dtype="int8")``'s."""
    jsplits = j_synthetic_fb15k(scale=0.01, seed=3)
    kw = dict(MB, dropout=0.0, num_table_shards=2, table_dtype="int8")
    jtr = JKGETrainer(jsplits, JTrainConfig(**kw))
    start = jax.tree_util.tree_map(np.array, jtr.params)    # copies
    jhist = jtr.fit()
    jtr.close()
    runs = []
    for dedup in (False, True):
        tr = KGETrainer(splits, TrainConfig(**kw, gather_dedup=dedup),
                        device="cpu")
        tr.params = convert.kge_model_from_jax(start, tr.kge_cfg,
                                               device="cpu")
        tr.opt_state = tr.optimizer.init(
            {n: p.detach() for n, p in tr.params.named_parameters()})
        runs.append((tr, tr.fit()))
        tr.close()
    (tr, hist), (tr_d, hist_d) = runs
    assert [h["losses"] for h in hist] == [h["losses"] for h in hist_d]
    for (n, a), (_, b) in zip(tr.params.named_parameters(),
                              tr_d.params.named_parameters()):
        assert torch.equal(a, b), n
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], **LOSS_TOL)
    want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                       jtr.params))
    for name, p in tr.params.named_parameters():
        assert not np.allclose(p.detach().numpy(),
                               convert.flatten_tree(start)[name],
                               **LOSS_TOL), name
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **LOSS_TOL)


def test_int8_trainer_losses_bitwise_across_table_shards(splits):
    """Int8 at 1 and 2 table shards: the same per-step losses and entity
    table, bitwise (a dense master is gathered as a one-shard stack)."""
    runs = {s: _fit(splits, num_table_shards=s, table_dtype="int8")
            for s in (1, 2)}
    (tr1, l1), (tr2, l2) = runs[1], runs[2]
    assert l1 == l2
    n = tr1.train_kg.num_entities
    assert torch.equal(tr1.params.entity_embedding,
                       unshard_table(tr2.params.entity_embedding, n))
    assert tr1.evaluate("valid") == tr2.evaluate("valid")


def test_feature_mode_rejects_sharding():
    from repro_torch.data import synthetic_citation2
    splits = synthetic_citation2(scale=0.0003, seed=0)
    with pytest.raises(ValueError, match="learned entity embeddings"):
        KGETrainer(splits, TrainConfig(num_table_shards=2, batch_size=64),
                   device="cpu")


def test_cli_minibatch_sharded_run_prints_pipeline_and_eval():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cli.main([
            "--device", "cpu", "--arch", "rgcn-fb15k237", "--use-kernel",
            "--scale", "0.01", "--epochs", "1", "--trainers", "2",
            "--hidden-dim", "16", "--batch-size", "64", "--table-shards",
            "2", "--gather-dedup", "--pipeline", "serial"])
    text = out.getvalue()
    assert "serial pipeline, batch 64, deduped gather" in text
    assert "mini-batch budgets" in text and "host exposed" in text
    assert "2-shard ranking" in text and "test_mrr" in text
    assert res["history"][0]["num_batches"] > 1
    assert np.isfinite(res["history"][0]["loss"])
