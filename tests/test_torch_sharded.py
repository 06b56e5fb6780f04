"""The port's row-sharded entity table (``repro_torch.sharding``, the
``scatter_add_onehot`` kernel's plain version, ``kernels.ops``' gathers,
sharded ranking) against the JAX package's, on the CPU.

The contract is the reference's: the sharded gather — fused or masked-sum
exchange, host or in-graph plan, deduplicated or not — is bitwise the
dense ``table[ids]`` gather, forward and gradients, and sharded ranking
gives exactly the dense metrics. Gradients of every row gather go through
``scatter_add_onehot``, whose sum over a row depends only on which slots
hit it and in what order; on the CPU its plain version is one
``index_add_`` in slot order.

Tolerance against JAX's scatter-add (``.at[].add``, another summation
order) and its Pallas kernel (one-hot matmuls): each side is within
``gamma_n Σ|g|`` of the exact row sum, ``n`` the row's hit count, so the
bound is twice that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.eval.sharded import sharded_ranking_metrics as j_sharded_metrics
from repro.kernels import ref as jref
from repro.kernels.sharded_gather import scatter_add_onehot as j_scatter
from repro.sharding.embedding import ShardedGatherPlan as JPlan
from repro.sharding.embedding import ShardedTableLayout as JLayout
from repro_torch import convert
from repro_torch.eval import ranking
from repro_torch.eval.sharded import sharded_ranking_metrics
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sharded_gather import (
    fused_gather, raise_if_flagged, scatter_add_onehot,
    scatter_add_onehot_plain,
)
from repro_torch.models.kge import KGEConfig
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.sharding import (
    ShardedGatherPlan, ShardedTableLayout, plan_local_gather,
    plan_local_gather_device, plan_unique_gather, shard_table,
    sharded_gather, unshard_table,
)

U32 = 2.0 ** -24


def gamma(n):
    return n * U32 / (1 - n * U32)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int32).numpy()


def scatter_bound(g, flat, owned, rows):
    """2 gamma_n Σ|g| per element, n = the row's owned hit count."""
    key = np.where(owned, flat, rows)
    absum = np.zeros((rows + 1, g.shape[1]))
    np.add.at(absum, key, np.abs(g.astype(np.float64)))
    hits = np.bincount(key, minlength=rows + 1)
    return 2 * gamma(hits[:rows, None]) * absum[:rows]


def plan_arrays(rng, n, s, v, dup=True):
    """Global ids with duplicates (a hub id repeated) and their layout."""
    ids = rng.integers(0, n, v)
    if dup:
        ids[::5] = ids[0]
    layout = ShardedTableLayout(n, s)
    local, owned = plan_local_gather(layout, ids)
    return ids, layout, local, owned


# ---------------------------------------------------------------------- #
# scatter_add_onehot's plain version
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s,n,d,v", [(2, 256, 8, 128), (4, 256, 16, 256),
                                     (4, 301, 75, 500)])
def test_scatter_add_plain_matches_ref_and_pallas(s, n, d, v):
    rng = np.random.default_rng(s + v)
    _, layout, local, owned = plan_arrays(rng, n, s, v)
    flat, anyo = ops.flat_gather_plan(torch.from_numpy(local),
                                      torch.from_numpy(owned),
                                      layout.rows_per_shard)
    anyo_np = anyo.numpy().copy()
    anyo_np[::7] = False                    # unowned slots (dedup padding)
    anyo = torch.from_numpy(anyo_np)
    g = rng.standard_normal((v, d)).astype(np.float32)
    r = layout.padded_rows
    got = scatter_add_onehot(torch.from_numpy(g), flat, anyo, r)
    assert got.shape == (r, d) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        bits(got), bits(ref.sharded_scatter_add_ref(torch.from_numpy(g),
                                                    flat, anyo, r)))
    bound = scatter_bound(g, flat.numpy(), anyo_np, r)
    want_ref = np.asarray(jref.sharded_scatter_add_ref(
        jnp.asarray(g), jnp.asarray(flat.numpy()), jnp.asarray(anyo_np), r))
    assert (np.abs(got.numpy() - want_ref) <= bound).all()
    # the Pallas kernel needs V and R padded to its 128-row tiles, as its
    # ops wrapper pads them (padded slots unowned)
    v_pad, r_pad = -(-v // 128) * 128, -(-r // 128) * 128
    g_p = np.zeros((v_pad, d), np.float32)
    g_p[:v] = g
    flat_p = np.zeros(v_pad, np.int32)
    flat_p[:v] = flat.numpy()
    own_p = np.zeros(v_pad, bool)
    own_p[:v] = anyo_np
    want_kernel = np.asarray(j_scatter(
        jnp.asarray(g_p), jnp.asarray(flat_p), jnp.asarray(own_p), r_pad,
        interpret=True))[:r]
    assert (np.abs(got.numpy() - want_kernel) <= bound).all()
    # rows no owned slot hits are exactly 0
    hit = np.zeros(r, bool)
    hit[flat.numpy()[anyo_np]] = True
    assert (got.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("case", ["all_unowned", "one_row", "empty",
                                  "ragged_rows", "no_mask"])
def test_scatter_add_edge_cases(case):
    rng = np.random.default_rng(3)
    v, d, r = 70, 5, 131
    g = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    flat = torch.from_numpy(rng.integers(0, r, v))
    owned = torch.ones(v, dtype=torch.bool)
    if case == "all_unowned":
        owned[:] = False
        assert (scatter_add_onehot(g, flat, owned, r) == 0).all()
        return
    if case == "one_row":
        flat[:] = 17
    if case == "empty":
        g, flat, owned = g[:0], flat[:0], owned[:0]
    mask = None if case == "no_mask" else owned
    got = scatter_add_onehot(g, flat, mask, r)
    want = torch.zeros((r, d)).index_add_(0, flat, g)
    assert got.shape == (r, d)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_scatter_add_plain_sums_each_row_in_slot_order():
    """The plain version adds a row's hits in slot order from +0: with
    values chosen so that the order shows in the rounding, its result is
    the left fold."""
    g = torch.tensor([[1.0], [2.0 ** -24], [2.0 ** -24], [-1.0]])
    flat = torch.tensor([0, 0, 0, 0])
    got = scatter_add_onehot_plain(g, flat, None, 1)
    acc = torch.zeros(1)
    for x in g:
        acc = acc + x
    assert torch.equal(got[0], acc)


# ---------------------------------------------------------------------- #
# gather_rows: the deterministic backward of every training-path gather
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(40, 6), (40, 3, 2)])
def test_gather_rows_backward_equals_index_select(shape):
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, shape[0], 300))
    ids[::3] = 7
    up = torch.from_numpy(
        rng.standard_normal((300,) + shape[1:]).astype(np.float32))
    a = base.clone().requires_grad_()
    b = base.clone().requires_grad_()
    out_a = ops.gather_rows(a, ids.int())
    out_b = torch.index_select(b, 0, ids)
    assert torch.equal(out_a, out_b)
    (out_a * up).sum().backward()
    (out_b * up).sum().backward()
    np.testing.assert_array_equal(bits(a.grad), bits(b.grad))


# ---------------------------------------------------------------------- #
# Plans
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [1, 2, 4])
def test_device_plan_equals_host_plan(s):
    rng = np.random.default_rng(s)
    ids, layout, local, owned = plan_arrays(rng, 301, s, 90)
    dl, do = plan_local_gather_device(s, layout.rows_per_shard,
                                      torch.from_numpy(ids).int())
    np.testing.assert_array_equal(dl.numpy(), local)
    np.testing.assert_array_equal(do.numpy(), owned)


@pytest.mark.parametrize("dedup", [False, True])
def test_stacked_plan_equals_reference(dedup):
    rng = np.random.default_rng(9)
    g = rng.integers(0, 301, (3, 70)).astype(np.int32)
    g[:, 60:] = 0                              # padding slots
    got = ShardedGatherPlan.for_stacked(ShardedTableLayout(301, 4), g,
                                        dedup=dedup)
    want = JPlan.for_stacked(JLayout(301, 4), g, dedup=dedup)
    np.testing.assert_array_equal(got.local_ids, want.local_ids)
    np.testing.assert_array_equal(got.owned, want.owned)
    if dedup:
        np.testing.assert_array_equal(got.inverse, want.inverse)
        assert got.inverse.dtype == want.inverse.dtype
    else:
        assert got.inverse is None and want.inverse is None


# ---------------------------------------------------------------------- #
# The sharded gather: forward and gradients bitwise the dense gather
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("exchange", ["fused", "masked_sum"])
def test_sharded_gather_and_grads_bitwise_dense(s, exchange):
    rng = np.random.default_rng(s)
    n, d, v = 301, 12, 200
    ids, layout, local, owned = plan_arrays(rng, n, s, v)
    dense = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    t_dense = dense.clone().requires_grad_()
    t_shard = shard_table(dense, layout).clone().requires_grad_()
    out_d = ops.gather_rows(t_dense, torch.from_numpy(ids))
    out_s = sharded_gather(t_shard, local, owned, exchange=exchange)
    np.testing.assert_array_equal(bits(out_d), bits(out_s))
    (out_d * up).sum().backward()
    (out_s * up).sum().backward()
    grad_s = t_shard.grad
    np.testing.assert_array_equal(bits(t_dense.grad),
                                  bits(unshard_table(grad_s, n)))
    # layout-padding rows get exactly zero
    assert (grad_s.reshape(-1, d)[n:] == 0).all()


@pytest.mark.parametrize("s", [2, 4])
def test_dedup_gather_and_grads_bitwise_dense(s):
    rng = np.random.default_rng(20 + s)
    n, d, v = 301, 8, 150
    ids, layout, _, _ = plan_arrays(rng, n, s, v)
    local, owned, inverse = plan_unique_gather(layout, ids)
    dense = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    t_dense = dense.clone().requires_grad_()
    t_shard = shard_table(dense, layout).clone().requires_grad_()
    out_d = ops.gather_rows(t_dense, torch.from_numpy(ids))
    out_s = sharded_gather(t_shard, local, owned, inverse=inverse)
    np.testing.assert_array_equal(bits(out_d), bits(out_s))
    (out_d * up).sum().backward()
    (out_s * up).sum().backward()
    np.testing.assert_array_equal(bits(t_dense.grad),
                                  bits(unshard_table(t_shard.grad, n)))


def test_sharded_gather_matches_reference_chain():
    rng = np.random.default_rng(2)
    n, d, s = 64, 6, 4
    ids, layout, local, owned = plan_arrays(rng, n, s, 40)
    dense = rng.standard_normal((n, d)).astype(np.float32)
    table = shard_table(torch.from_numpy(dense), layout)
    got = sharded_gather(table, local, owned)
    chain = ref.sharded_gather_ref(table, torch.from_numpy(local).long(),
                                   torch.from_numpy(owned))
    want = np.asarray(jref.sharded_gather_ref(
        jnp.asarray(table.numpy()), jnp.asarray(local), jnp.asarray(owned)))
    np.testing.assert_array_equal(got.numpy(), chain.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_unknown_exchange_rejected():
    table = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="unknown sim exchange"):
        sharded_gather(table, np.zeros((2, 1), np.int32),
                       np.ones((2, 1), bool), exchange="psum")


def test_fused_gather_unchecked_and_flag_reader_on_cpu():
    """On the CPU the plain gather raises on a broken plan whatever
    ``check`` says, and there is no flag to read."""
    table = torch.zeros((4, 2))
    with pytest.raises(IndexError):
        fused_gather(table, torch.tensor([5]), torch.tensor([True]),
                     check=False)
    raise_if_flagged(torch.device("cpu"))


# ---------------------------------------------------------------------- #
# Sharded ranking == dense; model layout and weights
# ---------------------------------------------------------------------- #
def grid(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("decoder", ["distmult", "transe"])
@pytest.mark.parametrize("s", [2, 4])
def test_sharded_ranking_equals_dense_and_reference(decoder, s):
    from repro.data import synthetic_fb15k as j_synthetic_fb15k
    from repro_torch.data import synthetic_fb15k
    splits = synthetic_fb15k(scale=0.01, seed=5)
    jsplits = j_synthetic_fb15k(scale=0.01, seed=5)
    rng = np.random.default_rng(s)
    n, r = splits["train"].num_entities, splits["train"].num_relations
    emb = grid(rng, (n, 8))
    emb[7] = emb[3]                         # exact ties
    dparams = {("rel_diag" if decoder == "distmult" else "rel_vec"):
               grid(rng, (2 * r, 8))}
    fidx = ranking.CSRFilterIndex.build(
        [splits[k].with_inverse_relations()
         for k in ("train", "valid", "test")])
    test = splits["test"].triplets()
    dense = ranking.ranking_metrics(emb, dparams, test, fidx,
                                    decoder=decoder, device="cpu")
    got = sharded_ranking_metrics(emb, dparams, test, fidx, s,
                                  decoder=decoder, device="cpu")
    assert got == dense
    via = ranking.ranking_metrics(emb, dparams, test, fidx, num_shards=s,
                                  decoder=decoder, device="cpu")
    assert via == dense
    from repro.eval.ranking import CSRFilterIndex as JIndex
    jfidx = JIndex.build([jsplits[k].with_inverse_relations()
                          for k in ("train", "valid", "test")])
    want = j_sharded_metrics(emb, dparams, jsplits["test"].triplets(), jfidx,
                             s, decoder=decoder, interpret=True)
    assert got == want


def lossy(rng, shape):
    """Multiples of 1/256 that int8 quantization rounds; the dequantized
    values times the 1/8 relation tables keep every score exact."""
    return (rng.integers(-300, 301, shape) / 256.0).astype(np.float32)


@pytest.fixture(scope="module")
def rank_splits():
    from repro.data import synthetic_fb15k as j_synthetic_fb15k
    from repro.eval.ranking import CSRFilterIndex as JIndex
    from repro_torch.data import synthetic_fb15k
    splits = synthetic_fb15k(scale=0.01, seed=5)
    jsplits = j_synthetic_fb15k(scale=0.01, seed=5)
    fidx = ranking.CSRFilterIndex.build(
        [splits[k].with_inverse_relations()
         for k in ("train", "valid", "test")])
    jfidx = JIndex.build([jsplits[k].with_inverse_relations()
                          for k in ("train", "valid", "test")])
    return splits, fidx, jsplits, jfidx


@pytest.mark.parametrize("decoder", ["distmult", "transe"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_int8_ranking_equals_reference(rank_splits, decoder, s):
    """Int8 filtered metrics ``==`` the reference's int8 sharded ranking
    from the same embeddings, and ``==`` at every shard count."""
    splits, fidx, jsplits, jfidx = rank_splits
    rng = np.random.default_rng(10 + s)
    n, r = splits["train"].num_entities, splits["train"].num_relations
    emb = lossy(rng, (n, 8))
    emb[::4] /= 16
    emb[7] = emb[3]                         # exact ties
    dparams = {("rel_diag" if decoder == "distmult" else "rel_vec"):
               grid(rng, (2 * r, 8))}
    test = splits["test"].triplets()
    got = ranking.ranking_metrics(emb, dparams, test, fidx, num_shards=s,
                                  decoder=decoder, table_dtype="int8",
                                  device="cpu")
    want = j_sharded_metrics(emb, dparams, jsplits["test"].triplets(),
                             jfidx, s, decoder=decoder, interpret=True,
                             table_dtype="int8")
    assert got == want
    for other in (1, 4):
        assert sharded_ranking_metrics(
            emb, dparams, test, fidx, other, decoder=decoder,
            table_dtype="int8", device="cpu") == got
    # == the fp32 ranking of the dequantized table
    from repro_torch.sharding import dequantize_rows, quantize_rows
    dq = dequantize_rows(*quantize_rows(torch.from_numpy(emb)))
    assert ranking.ranking_metrics(dq, dparams, test, fidx, decoder=decoder,
                                   device="cpu") == got
    with pytest.raises(ValueError, match="table_dtype"):
        sharded_ranking_metrics(emb, dparams, test, fidx, s,
                                table_dtype="int4", device="cpu")


def test_sharded_model_round_trips_through_convert():
    from repro.models.kge import KGEConfig as JKGEConfig
    from repro.models.kge import init_kge_params as j_init
    from repro.models.rgcn import RGCNConfig as JRGCNConfig
    jcfg = JKGEConfig(JRGCNConfig(num_entities=30, num_relations=8,
                                  hidden_dim=12, num_table_shards=4))
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(2), jcfg))
    assert tree["entity_embedding"].shape == (4, 8, 12)
    cfg = KGEConfig(RGCNConfig(num_entities=30, num_relations=8,
                               hidden_dim=12, num_table_shards=4))
    model = convert.kge_model_from_jax(tree, cfg, device="cpu")
    assert model.entity_embedding.shape == (4, 8, 12)
    back = convert.kge_model_to_jax(model)
    assert back["entity_embedding"].tobytes() == \
        tree["entity_embedding"].tobytes()
    dense_cfg = KGEConfig(RGCNConfig(num_entities=30, num_relations=8,
                                     hidden_dim=12))
    with pytest.raises(ValueError, match="does not match"):
        convert.kge_model_from_jax(tree, dense_cfg, device="cpu")


def test_sharded_init_is_the_dense_draw():
    from repro_torch.models.kge import init_kge_params
    kw = dict(num_entities=30, num_relations=8, hidden_dim=12)
    dense = init_kge_params(np.random.default_rng(4),
                            KGEConfig(RGCNConfig(**kw)), device="cpu")
    shard = init_kge_params(np.random.default_rng(4),
                            KGEConfig(RGCNConfig(**kw, num_table_shards=4)),
                            device="cpu")
    table = shard.entity_embedding.detach()
    assert table.shape == (4, 8, 12)
    np.testing.assert_array_equal(unshard_table(table, 30).numpy(),
                                  dense.entity_embedding.detach().numpy())
    assert (table.reshape(-1, 12)[30:] == 0).all()
    for (name, a), (_, b) in zip(list(dense.named_parameters())[1:],
                                 list(shard.named_parameters())[1:]):
        assert torch.equal(a, b), name


def test_fullgraph_training_with_sharded_table_equals_dense():
    """The full-graph path gathers the sharded table through the in-graph
    plan: losses and parameters are those of the dense table, bitwise."""
    from repro_torch.data import synthetic_fb15k
    from repro_torch.training import KGETrainer, TrainConfig
    splits = synthetic_fb15k(scale=0.01, seed=3)
    runs = {}
    for s in (1, 2):
        tr = KGETrainer(splits, TrainConfig(
            num_trainers=2, epochs=2, hidden_dim=16, use_kernel=True,
            num_table_shards=s), device="cpu")
        runs[s] = (tr, [h["loss"] for h in tr.fit()])
    (dense, l1), (shard, l2) = runs[1], runs[2]
    assert l1 == l2
    n = dense.train_kg.num_entities
    assert torch.equal(dense.params.entity_embedding,
                       unshard_table(shard.params.entity_embedding, n))
    assert dense.evaluate("valid") == shard.evaluate("valid")
