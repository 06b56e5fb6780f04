"""ogbl-citation2 through the port, against the JAX package on the CPU:
feature-mode edge mini-batch training (``--arch rgcn-citation2``) and the
ogbl candidate-list ranking protocol.

* The CLI trains the synthetic stand-in to its ``[eval]`` line, with the
  reference's batch-size default and its errors for a sharded or int8
  table (feature-mode models have no table).
* From the reference's initial weights at dropout 0 the feature-mode
  trainer's losses and parameters are within ``rtol=1e-3, atol=1e-4`` of
  ``repro.KGETrainer``'s; with dropout 0.2 the serial and async pipelines
  give bitwise-equal losses and parameters.
* The candidate protocol, dense and sharded at 1, 2 and 4 shards over fp32
  and int8 tables, gives exactly (``==``) the reference's metrics for
  every decoder, on values where every score is exact (multiples of 1/8,
  or of 1/256 before int8 rounding), with duplicate candidates and exact
  ties across shard boundaries.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic_citation2 as j_synthetic_citation2
from repro.eval.ranking import CSRFilterIndex as JIndex
from repro.eval.ranking import ranking_metrics as j_ranking_metrics
from repro.eval.sharded import sharded_ranking_metrics as j_sharded_metrics
from repro.training import KGETrainer as JKGETrainer
from repro.training import TrainConfig as JTrainConfig
from repro_torch import convert
from repro_torch.data import synthetic_citation2
from repro_torch.eval import ranking
from repro_torch.eval.sharded import sharded_ranking_metrics
from repro_torch.launch import train as train_cli
from repro_torch.models.decoders import registered_decoders
from repro_torch.training import KGETrainer, TrainConfig

LOSS_TOL = dict(rtol=1e-3, atol=1e-4)
SCALE = 0.0003
SMALL = dict(num_trainers=2, hidden_dim=8, batch_size=256, epochs=2,
             seed=0)
CLI = ["--device", "cpu", "--arch", "rgcn-citation2", "--scale", str(SCALE),
       "--trainers", "2", "--epochs", "1", "--hidden-dim", "8"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    the suite runs on several workers at once, and their spinning thread
    pools crowd each other out (a step here took 100 times as long under
    load as alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def splits():
    return synthetic_citation2(scale=SCALE, seed=0)


# ---------------------------------------------------------------------- #
# The CLI
# ---------------------------------------------------------------------- #
def test_cli_runs_to_eval_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cli.main(CLI + ["--batch-size", "256"])
    text = out.getvalue()
    assert "[train] ogbl-citation2:" in text
    assert "async pipeline, batch 256" in text and "mini-batch budgets" in text
    assert "epoch   1 loss=" in text and "[eval]" in text
    assert "dense ranking" in text and "test_mrr" in text
    assert res["trainer"].features.shape[1] == 128
    assert res["history"][0]["num_batches"] > 1
    assert np.isfinite(res["history"][0]["loss"])


@pytest.mark.parametrize("extra,error", [
    ([], None),                  # the reference's default batch: 4096
    (["--table-shards", "2"], "learned entity embeddings"),
    (["--table-dtype", "int8"], "learned entity embeddings"),
])
def test_cli_batch_default_and_table_options(extra, error):
    args = train_cli.parse_args(CLI + extra)
    if error is not None:
        with pytest.raises(ValueError, match=error):
            train_cli.make_trainer(args)
        return
    tr = train_cli.make_trainer(args)
    tr.close()
    assert tr.cfg.batch_size == 4096 and tr.budget is not None
    assert tr.cfg.hidden_dim == 8 and tr.kge_cfg.rgcn.feature_dim == 128


# ---------------------------------------------------------------------- #
# The feature-mode trainer
# ---------------------------------------------------------------------- #
def test_feature_trainer_trajectory_near_reference(splits):
    jsplits = j_synthetic_citation2(scale=SCALE, seed=0)
    kw = dict(SMALL, dropout=0.0, pipeline="serial")
    jtr = JKGETrainer(jsplits, JTrainConfig(**kw))
    start = jax.tree_util.tree_map(np.array, jtr.params)     # copies
    jhist = jtr.fit()
    jtr.close()
    tr = KGETrainer(splits, TrainConfig(**kw), device="cpu")
    np.testing.assert_array_equal(tr.features.numpy(),
                                  np.asarray(jtr.features))
    tr.params = convert.kge_model_from_jax(start, tr.kge_cfg, device="cpu")
    tr.opt_state = tr.optimizer.init(
        {n: p.detach() for n, p in tr.params.named_parameters()})
    hist = tr.fit()
    tr.close()
    assert [h["num_batches"] for h in hist] == \
        [h["num_batches"] for h in jhist]
    assert hist[0]["num_batches"] > 1
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], **LOSS_TOL)
    assert "entity_embedding" not in dict(tr.params.named_parameters())
    want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                       jtr.params))
    for name, p in tr.params.named_parameters():
        assert not np.allclose(p.detach().numpy(),
                               convert.flatten_tree(start)[name],
                               **LOSS_TOL), name
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **LOSS_TOL)
    got, jwant = tr.evaluate("test"), jtr.evaluate("test")
    assert set(got) == set(jwant)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [jwant[k] for k in sorted(got)], **LOSS_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serial_equals_async_with_dropout(splits, use_kernel):
    runs = {}
    for kind in ("serial", "async"):
        tr = KGETrainer(splits, TrainConfig(**SMALL, dropout=0.2,
                                            pipeline=kind,
                                            use_kernel=use_kernel),
                        device="cpu")
        runs[kind] = (tr, [h["losses"] for h in tr.fit()])
        tr.close()
    (tr_s, losses_s), (tr_a, losses_a) = runs["serial"], runs["async"]
    assert losses_s == losses_a
    assert sum(len(x) for x in losses_s) > 2
    for (n, a), (_, b) in zip(tr_s.params.named_parameters(),
                              tr_a.params.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------- #
# The ogbl candidate-list protocol
# ---------------------------------------------------------------------- #
N, D, R, C, T = 41, 8, 3, 24, 30


def grid(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


def lossy(rng, shape):
    """Multiples of 1/256 that int8 quantization rounds; the dequantized
    values times the 1/8 relation tables keep every score exact."""
    return (rng.integers(-300, 301, shape) / 256.0).astype(np.float32)


def candidate_setup(seed, decoder, values=grid):
    """Embeddings with exact ties (rows 3/7 and 11/N-1, across shard
    boundaries at 2 and 4 shards), test triplets whose true tails have a
    tie partner among their candidates, and candidate lists with a
    duplicated id per row."""
    rng = np.random.default_rng(seed)
    emb = values(rng, (N, D))
    emb[7], emb[N - 1] = emb[3], emb[11]
    if decoder == "rotate":
        # zero phases: cos and sin exact in both packages, so every score
        # stays exact
        dparams = {"rel_phase": np.zeros((R, D // 2), np.float32)}
    else:
        name = {"distmult": "rel_diag", "transe": "rel_vec",
                "complex": "rel_complex"}[decoder]
        dparams = {name: grid(rng, (R, D))}
    tests = np.stack([rng.integers(0, N, T), rng.integers(0, R, T),
                      rng.integers(0, N, T)], axis=1).astype(np.int32)
    tests[::3, 2] = 3
    tests[1::3, 2] = 11
    cands = rng.integers(0, N, (T, C)).astype(np.int32)
    cands[:, 0], cands[:, 1], cands[:, 2] = 7, N - 1, 3
    cands[:, 4] = cands[:, 5]
    # the lists exclude the true tail (its tie partner stays)
    for i, t in enumerate(tests[:, 2]):
        cands[i][cands[i] == t] = (t + 1) % N
    return emb, dparams, tests, cands


@pytest.mark.parametrize("decoder", registered_decoders())
def test_dense_candidate_protocol_equals_reference(decoder):
    emb, dparams, tests, cands = candidate_setup(1, decoder)
    fidx = ranking.CSRFilterIndex.build([])
    got = ranking.ranking_metrics(emb, dparams, tests, fidx,
                                  candidates=cands, batch_size=8,
                                  decoder=decoder, device="cpu")
    want = j_ranking_metrics(emb, dparams, tests, JIndex.build([]),
                             candidates=cands, batch_size=8,
                             decoder=decoder)
    assert got == want
    assert 0 < got["mrr"] < 1


@pytest.mark.parametrize("table_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("decoder", registered_decoders())
def test_sharded_candidate_protocol_equals_dense_and_reference(
        decoder, s, table_dtype):
    values = grid if table_dtype == "fp32" else lossy
    emb, dparams, tests, cands = candidate_setup(2 + s, decoder, values)
    fidx = ranking.CSRFilterIndex.build([])
    kw = dict(candidates=cands, batch_size=8, decoder=decoder)
    got = sharded_ranking_metrics(emb, dparams, tests, fidx, s,
                                  table_dtype=table_dtype, device="cpu",
                                  **kw)
    via = ranking.ranking_metrics(emb, dparams, tests, fidx, num_shards=s,
                                  table_dtype=table_dtype, device="cpu",
                                  **kw)
    table = emb
    if table_dtype == "int8":
        from repro_torch.sharding import dequantize_rows, quantize_rows
        table = dequantize_rows(*quantize_rows(torch.from_numpy(emb)))
        assert not torch.equal(table, torch.from_numpy(emb))
    dense = ranking.ranking_metrics(table, dparams, tests, fidx,
                                    device="cpu", **kw)
    want = j_sharded_metrics(emb, dparams, tests, JIndex.build([]), s,
                             table_dtype=table_dtype, **kw)
    assert got == via == dense == want


@pytest.mark.parametrize("s", [2, 4])
def test_candidate_ties_stay_exact_at_inexact_scores(s):
    """RotatE at random phases (scores no longer exact): the true tail is
    scored in the candidates' product, so its tie partner ties it exactly,
    and the sharded protocol still gives the dense metrics."""
    emb, _, tests, cands = candidate_setup(9, "rotate")
    rng = np.random.default_rng(9)
    dparams = {"rel_phase": rng.uniform(-np.pi, np.pi, (R, D // 2))
               .astype(np.float32)}
    fidx = ranking.CSRFilterIndex.build([])
    kw = dict(candidates=cands, batch_size=8, decoder="rotate",
              device="cpu")
    dense = ranking.ranking_metrics(emb, dparams, tests, fidx, **kw)
    assert sharded_ranking_metrics(emb, dparams, tests, fidx, s,
                                   **kw) == dense
    # rows whose true tail is 3 hold its twin 7: never a strict win
    rows = tests[:, 2] == 3
    alone = ranking.ranking_metrics(
        emb, dparams, tests[rows], fidx, hits_ks=(1,),
        candidates=np.where(cands[rows] == 7, 5, cands[rows]),
        decoder="rotate", device="cpu")
    tied = ranking.ranking_metrics(emb, dparams, tests[rows], fidx,
                                   hits_ks=(1,), candidates=cands[rows],
                                   decoder="rotate", device="cpu")
    assert tied["mrr"] < alone["mrr"]
