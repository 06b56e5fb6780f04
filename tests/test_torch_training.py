"""The PyTorch port's training loop and evaluation (``repro_torch.training``,
``repro_torch.eval.ranking``, ``repro_torch.launch.train``) against the JAX
package's, on the CPU.

The trainer test mirrors ``tests/test_system.py``'s kernel-path run: the
synthetic FB15k-237 stand-in at scale 0.01, 2 trainers, d = 16, dropout 0,
``use_kernel=True`` (the JAX side runs its Pallas kernels in interpret
mode). The port starts from the JAX trainer's initial parameters and is
handed, epoch by epoch and trainer by trainer, the negatives the JAX
trainer draws; per-epoch losses must agree within ``rtol=1e-3, atol=1e-4``
and the final parameters within ``rtol=1e-3, atol=1e-4`` (Adam's update is
O(lr) per step whatever the gradient's size, so a gradient that differs in
its last bits cannot move a parameter by more than that).

Evaluation from the same embeddings must give the same rank counts: the
embeddings and relation tables are multiples of 1/8, so every score is
exact in fp32 and the filtered MRR and Hits@k are ``==``.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.core.negative import constraint_based_negatives as j_negatives
from repro.data import synthetic_fb15k as j_synthetic_fb15k
from repro.eval.ranking import evaluate_both_directions as j_evaluate
from repro.models.kge import KGEConfig as JKGEConfig
from repro.models.kge import init_kge_params as j_init_kge_params
from repro.models.rgcn import RGCNConfig as JRGCNConfig
from repro.training import KGETrainer as JKGETrainer
from repro.training import TrainConfig as JTrainConfig
from repro.training.distributed import split_trainer_keys
from repro_torch import convert
from repro_torch.core.graph import KnowledgeGraph
from repro_torch.data import FullGraphPipeline, PlanSizes, synthetic_fb15k
from repro_torch.eval import ranking
from repro_torch.launch import train as train_cli
from repro_torch.models import kge
from repro_torch.models.kge import KGEConfig
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.training import KGETrainer, TrainConfig
from repro_torch.training.distributed import trainer_generators

LOSS_TOL = dict(rtol=1e-3, atol=1e-4)
SMALL = ["--device", "cpu", "--arch", "rgcn-fb15k237", "--use-kernel",
         "--scale", "0.01", "--epochs", "1", "--trainers", "2",
         "--hidden-dim", "16"]


def host_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def jax_negatives(jtr, epoch):
    """The negatives the JAX full-graph step draws in ``epoch``, per
    trainer (``fullgraph_loss``: split the trainer key, draw with the
    first half)."""
    keys = split_trainer_keys(jtr._key, jtr.cfg.num_trainers, epoch)
    pad = jtr.padded
    out = []
    for p in range(jtr.cfg.num_trainers):
        k_neg, _ = jax.random.split(keys[p])
        pos = np.stack([pad.src[p], pad.rel[p], pad.dst[p]], 1)
        neg, _ = j_negatives(k_neg, pos, jtr.cfg.num_negatives,
                             int(pad.num_core_vertices[p]))
        out.append(torch.from_numpy(np.asarray(neg)))
    return out


def train_both(**extra):
    """Both trainers after 3 epochs from the same start and negatives."""
    splits = synthetic_fb15k(scale=0.01, seed=3)
    jsplits = j_synthetic_fb15k(scale=0.01, seed=3)
    kw = dict(num_trainers=2, epochs=3, hidden_dim=16, learning_rate=0.05,
              use_kernel=True, dropout=0.0, **extra)
    jtr = JKGETrainer(jsplits, JTrainConfig(**kw))
    tr = KGETrainer(splits, TrainConfig(**kw), device="cpu")
    tr.params = convert.kge_model_from_jax(host_tree(jtr.params),
                                           tr.kge_cfg, device="cpu")
    tr.opt_state = tr.optimizer.init(
        {n: p.detach() for n, p in tr.params.named_parameters()})
    draws = [neg for epoch in range(1, 4)
             for neg in jax_negatives(jtr, epoch)]
    mp = pytest.MonkeyPatch()
    mp.setattr(kge, "fullgraph_negatives",
               lambda cfg, part, generator: draws.pop(0))
    try:
        hist = tr.fit()
    finally:
        mp.undo()
    assert not draws
    jhist = jtr.fit()
    return tr, jtr, hist, jhist


@pytest.fixture(scope="module")
def trained():
    return train_both()


def test_int8_trainer_losses_and_params_match_reference():
    """``table_dtype="int8"`` full-graph training: the same gate as the
    fp32 trainer's against ``repro.KGETrainer(table_dtype="int8")``."""
    tr, jtr, hist, jhist = train_both(table_dtype="int8")
    assert tr.kge_cfg.rgcn.table_dtype == "int8"
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], **LOSS_TOL)
    want = convert.flatten_tree(host_tree(jtr.params))
    for name, p in tr.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **LOSS_TOL)
    assert set(tr.evaluate("valid")) == {"valid_mrr", "valid_hits@1",
                                         "valid_hits@3", "valid_hits@10"}


def test_trainer_losses_and_params_match_reference(trained):
    tr, jtr, hist, jhist = trained
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], **LOSS_TOL)
    assert hist[-1]["loss"] < hist[0]["loss"]
    want = convert.flatten_tree(host_tree(jtr.params))
    for name, p in tr.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **LOSS_TOL)
    rec = hist[0]
    assert rec["num_batches"] == 1 and rec["epoch"] == 1
    assert rec["t_step"] > 0 and rec["t_epoch"] >= rec["t_step"]
    assert int(tr.opt_state.step) == 3


def test_encode_all_entities_matches_reference(trained):
    tr, jtr, _, _ = trained
    port = convert.kge_model_from_jax(host_tree(jtr.params), tr.kge_cfg,
                                      device="cpu")
    tr_params, tr.params = tr.params, port
    try:
        got = tr.encode_all_entities()
    finally:
        tr.params = tr_params
    want = jtr.encode_all_entities()
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def grid(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("decoder", ["distmult", "transe"])
def test_evaluation_from_same_embeddings_equals_reference(decoder):
    jsplits = j_synthetic_fb15k(scale=0.01, seed=5)
    splits = synthetic_fb15k(scale=0.01, seed=5)
    rng = np.random.default_rng(0)
    n, r = jsplits["train"].num_entities, jsplits["train"].num_relations
    emb = grid(rng, (n, 8))
    emb[7] = emb[3]                         # exact ties
    dparams = {("rel_diag" if decoder == "distmult" else "rel_vec"):
               grid(rng, (2 * r, 8))}
    filt = [jsplits[k] for k in ("train", "valid", "test")]
    want = j_evaluate(emb, dparams, jsplits["test"], filt, r,
                      decoder=decoder)
    got = ranking.evaluate_both_directions(
        emb, dparams, splits["test"],
        [splits[k] for k in ("train", "valid", "test")], r,
        decoder=decoder, device="cpu")
    assert got == want
    m = ranking.ranking_metrics(torch.from_numpy(emb), dparams,
                                splits["test"].triplets()[:5],
                                ranking.CSRFilterIndex.build([]),
                                decoder=decoder, batch_size=2)
    assert set(m) == {"mrr", "hits@1", "hits@3", "hits@10"}


def test_evaluate_reports_split_metrics(trained):
    tr, _, _, _ = trained
    m = tr.evaluate("test")
    assert set(m) == {"test_mrr", "test_hits@1", "test_hits@3",
                      "test_hits@10"}
    assert 0 < m["test_mrr"] <= 1


def test_ranking_unported_protocols_raise():
    """Both protocols the earlier slices left out now rank: the ogbl
    candidate-list protocol (the true tail against its row's list, the
    list's copy of a tie counted half) and int8 ranking, exactly as the
    fp32 ranking of the dequantized table."""
    fidx = ranking.CSRFilterIndex.build([])
    emb = np.eye(4, 2, dtype=np.float32)
    params = {"rel_diag": np.ones((1, 2), np.float32)}
    trip = np.array([[0, 0, 0], [1, 0, 1]], np.int32)
    # row 0: candidates 1 (score 0) and 2, 3 (score 0) below the true 1.0;
    # row 1: candidate 0 below, its own twin 1 ties (rank 1.5)
    cands = np.array([[1, 2, 3], [0, 1, 2]], np.int32)
    got = ranking.ranking_metrics(emb, params, trip, fidx, candidates=cands,
                                  device="cpu")
    assert got == {"mrr": 0.5 * (1.0 + 1 / 1.5), "hits@1": 0.5,
                   "hits@3": 1.0, "hits@10": 1.0}
    emb = np.random.default_rng(0).standard_normal((6, 2)).astype(
        np.float32)
    trip = np.array([[0, 0, 1], [2, 0, 5], [4, 0, 3]], np.int32)
    got = ranking.ranking_metrics(emb, params, trip, fidx,
                                  table_dtype="int8", device="cpu")
    from repro_torch.sharding import dequantize_rows, quantize_rows
    dq = dequantize_rows(*quantize_rows(torch.from_numpy(emb)))
    assert got == ranking.ranking_metrics(dq, params, trip, fidx,
                                          device="cpu")


def test_cli_runs_to_eval_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cli.main(SMALL)
    text = out.getvalue()
    assert "epoch   1 loss=" in text and "[eval]" in text
    assert "test_mrr" in text
    assert np.isfinite(res["history"][0]["loss"])


def test_cli_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(args)


def test_cli_int8_runs_to_eval_line():
    """``--table-dtype int8`` (full-graph) trains and ranks over the int8
    table."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cli.main(SMALL + ["--table-dtype", "int8"])
    text = out.getvalue()
    assert "int8 table" in text and "[eval]" in text and "test_mrr" in text
    assert "1-shard ranking over the int8 table" in text
    assert np.isfinite(res["history"][0]["loss"])


@pytest.mark.parametrize("extra,item", [
    (["--arch", "deepseek-v2-lite-16b", "--steps", "1", "--batch", "1",
      "--seq", "8"], "item 7"),
])
def test_cli_unported_options_raise(extra, item):
    """The KGE command line with an LM ``--arch`` last trains that LM
    (deepseek-v2-lite-16b waited for ROADMAP Queue 1 ``item`` d and runs
    now): one finite loss, no KGE evaluation."""
    losses = train_cli.main(SMALL + extra)
    assert isinstance(losses, list) and len(losses) == 1, item
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("exchange", ["psum", "psum_scatter", "alltoall"])
def test_cli_spmd_exchanges_rejected_on_the_simulated_step(exchange):
    with pytest.raises(ValueError, match="not available on the simulated"):
        train_cli.main(SMALL + ["--table-shards", "2", "--gather-exchange",
                                exchange])


def test_convert_round_trip_is_bitwise():
    jcfg = JKGEConfig(JRGCNConfig(num_entities=30, num_relations=8,
                                  hidden_dim=12), decoder="complex")
    tree = host_tree(j_init_kge_params(jax.random.PRNGKey(2), jcfg))
    cfg = KGEConfig(RGCNConfig(num_entities=30, num_relations=8,
                               hidden_dim=12), decoder="complex")
    model = convert.kge_model_from_jax(tree, cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert names == ["entity_embedding", "layers.0.bases", "layers.0.coeffs",
                     "layers.0.self_weight", "layers.1.bases",
                     "layers.1.coeffs", "layers.1.self_weight",
                     "decoder.rel_complex"]
    back = convert.kge_model_to_jax(model)
    flat, flat_back = convert.flatten_tree(tree), convert.flatten_tree(back)
    assert flat.keys() == flat_back.keys()
    for k in flat:
        assert flat[k].dtype == flat_back[k].dtype
        assert flat[k].tobytes() == flat_back[k].tobytes(), k
    tree["layers"][1]["bases"] = tree["layers"][1]["bases"][:1]
    with pytest.raises(ValueError, match="does not match"):
        convert.kge_model_from_jax(tree, cfg, device="cpu")


def test_trainer_generators_are_reproducible_and_distinct():
    a = trainer_generators(1, 3, 2, torch.device("cpu"))
    b = trainer_generators(1, 3, 2, torch.device("cpu"))
    draws = [torch.rand(4, generator=g) for g in a]
    assert all(torch.equal(x, torch.rand(4, generator=g))
               for x, g in zip(draws, b))
    assert not torch.equal(draws[0], draws[1])
    other = trainer_generators(1, 3, 3, torch.device("cpu"))
    assert not torch.equal(draws[0], torch.rand(4, generator=other[0]))


def test_full_graph_pipeline_copies_the_batch_once(trained):
    pipe = FullGraphPipeline(trained[0].padded, torch.device("cpu"),
                             PlanSizes(trained[0].train_kg.num_relations))
    first = next(iter(pipe.device_batches(1)))
    second = next(iter(pipe.device_batches(2)))
    assert first is second
    assert pipe.last_stats.num_batches == 1
    np.testing.assert_array_equal(first["src"].numpy(),
                                  trained[0].padded.src)


def test_trainer_unported_config_raises():
    """spmd=True without a process group raises the reference's
    ValueError (the multi-process step is ported since, and needs one); an
    int8 table (ported since) trains, with the reference's errors for an
    unknown dtype and for feature mode."""
    splits = {"train": KnowledgeGraph(np.zeros(1), np.zeros(1), np.ones(1),
                                      2, 1)}
    with pytest.raises(ValueError, match="spmd=True needs an initialised "
                                         "process group"):
        KGETrainer(splits, TrainConfig(spmd=True), device="cpu")
    with pytest.raises(ValueError, match="table_dtype='int4'"):
        KGETrainer(splits, TrainConfig(table_dtype="int4"), device="cpu")
    from repro_torch.data import synthetic_citation2
    with pytest.raises(ValueError, match="learned entity embeddings"):
        KGETrainer(synthetic_citation2(scale=0.0003, seed=0),
                   TrainConfig(table_dtype="int8", batch_size=64),
                   device="cpu")
    tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3), TrainConfig(
        num_trainers=2, epochs=1, hidden_dim=8, table_dtype="int8"),
        device="cpu")
    before = tr.params.entity_embedding.detach().clone()
    rec = tr.train_epoch()
    assert np.isfinite(rec["loss"]) and rec["num_batches"] == 1
    assert not torch.equal(before, tr.params.entity_embedding)
