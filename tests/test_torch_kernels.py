"""The PyTorch port's kernels (``repro_torch.kernels``) against the JAX
package's Pallas kernels, on the CPU.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode. The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``. Inputs are drawn with numpy from fixed seeds.

Tolerances: on inputs that are multiples of 1/8 in a small range every
product and partial sum is exact in fp32, so scores must be ``==``. On
Gaussian inputs the two sides sum ``d`` products in different orders; each
is within ``gamma_{d+2} · S`` of the exact value (``S = Σ|q_j c_j| +
|q_bias| + |c_bias|``, ``gamma_n = n u / (1 - n u)``), and the ``neg_l2``
bound propagates that through the sqrt (see :func:`score_bound`) instead
of comparing with a fixed tolerance the sqrt's slope can defeat.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sharded_gather import fused_gather as jax_fused_gather
from repro_torch.kernels import (
    fused_gather, kge_score, ops, ref, topk_plain, topk_scores,
)
from repro_torch.kernels.kge_score import kge_score_v1
from repro_torch.kernels.rgcn_message import basis_message_v1, segment_sum_v1
from repro_torch.kernels.sharded_gather import (
    fused_dequant_gather_v1, fused_gather_v1, scatter_add_onehot_v1,
)
from repro_torch.kernels.topk import stream_splits, topk_scores_v1
from repro_torch.kernels.wkv_chunk import wkv_chunked_v1

U32 = 2.0 ** -24


def grid(rng, shape, lo=-8, hi=8):
    """Multiples of 1/8 in [lo/8, hi/8]: fp32 sums of their products are
    exact at these sizes."""
    return (rng.integers(lo, hi + 1, shape) / 8.0).astype(np.float32)


def mixed_bias(rng, shape):
    """A post-epilogue bias holding 0, FILTER_BIAS (-1e9) and -inf."""
    choice = rng.choice(3, size=shape, p=[.7, .15, .15])
    return np.choose(choice, [np.float32(0), np.float32(-1e9),
                              np.float32(-np.inf)]).astype(np.float32)


def neg_l2_inputs(u, cand):
    """TransE's norm-expansion query form: q = -2u, q_bias = |u|²,
    c_bias = |c|²."""
    return (-2.0 * u, (u * u).sum(1).astype(np.float32),
            (cand * cand).sum(1).astype(np.float32))


def jax_scores(q, cand, bias, qb, cb, epilogue):
    return np.asarray(jops.kge_score_padded(
        jnp.asarray(q), jnp.asarray(cand), jnp.asarray(bias),
        jnp.asarray(qb), jnp.asarray(cb), epilogue=epilogue,
        interpret=True))


def port_scores(q, cand, bias, qb, cb, epilogue):
    t = torch.from_numpy
    return ops.kge_score_padded(t(q), t(cand), t(bias), t(qb), t(cb),
                                epilogue=epilogue).numpy()


def score_bound(q, cand, qb, cb, bias, epilogue):
    """Elementwise bound on the difference of two fp32 evaluations of the
    query form that sum in different orders (float64 reference)."""
    d = q.shape[1]
    gamma = (d + 2) * U32 / (1 - (d + 2) * U32)
    q64, c64 = q.astype(np.float64), cand.astype(np.float64)
    s = np.abs(q64) @ np.abs(c64).T + np.abs(qb)[:, None] + np.abs(cb)[None]
    tol = 2 * gamma * s
    x = q64 @ c64.T + qb[:, None] + cb[None]
    if epilogue == "neg_l2":
        # |sqrt(a) - sqrt(b)| <= min(|a - b| / sqrt(min(a, b)), sqrt|a - b|)
        a_lo = np.maximum(x - tol, 0.0) + 1e-9
        tol = np.minimum(tol / np.sqrt(a_lo), np.sqrt(tol))
        out = -np.sqrt(np.maximum(x, 0) + 1e-9) + bias
    else:
        out = x + bias
    # rounding of the epilogue and of the post-epilogue bias
    return tol + 2 * np.spacing(np.abs(np.nan_to_num(out, neginf=0.0)
                                       ).astype(np.float32))


# ---------------------------------------------------------------------- #
# kge_score
# ---------------------------------------------------------------------- #
SCORE_SHAPES = [(5, 77, 16), (8, 130, 8), (1, 3, 4), (9, 128, 12)]


@pytest.mark.parametrize("epilogue", ["bilinear", "neg_l2"])
@pytest.mark.parametrize("b,c,d", SCORE_SHAPES)
def test_kge_score_exact_inputs_equal_jax(epilogue, b, c, d):
    """Ragged B and C, both epilogues, a bias of 0 / -1e9 / -inf: on exact
    inputs the plain version equals the Pallas kernel bit for bit."""
    rng = np.random.default_rng(b * 1000 + c + d)
    u, cand = grid(rng, (b, d)), grid(rng, (c, d))
    cand[0] = u[0]                     # a zero-distance pair
    if epilogue == "neg_l2":
        q, qb, cb = neg_l2_inputs(u, cand)
    else:
        q, qb, cb = u, grid(rng, (b,)), grid(rng, (c,))
    bias = mixed_bias(rng, (b, c))
    want = jax_scores(q, cand, bias, qb, cb, epilogue)
    got = port_scores(q, cand, bias, qb, cb, epilogue)
    assert got.dtype == np.float32 and got.shape == (b, c)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("epilogue", ["bilinear", "neg_l2"])
@pytest.mark.parametrize("b,c,d", SCORE_SHAPES)
def test_kge_score_gaussian_within_bound_of_jax(epilogue, b, c, d):
    """Gaussian inputs with near-zero distances: every finite score within
    the propagated summation-order bound, -inf exactly where JAX has it."""
    rng = np.random.default_rng(7 + b + c + d)
    u = rng.normal(0, .3, (b, d)).astype(np.float32)
    cand = rng.normal(0, .3, (c, d)).astype(np.float32)
    cand[:min(b, c)] = u[:min(b, c)] + np.float32(1e-3)
    if epilogue == "neg_l2":
        q, qb, cb = neg_l2_inputs(u, cand)
    else:
        q = u
        qb = rng.normal(size=b).astype(np.float32)
        cb = rng.normal(size=c).astype(np.float32)
    bias = mixed_bias(rng, (b, c))
    want = jax_scores(q, cand, bias, qb, cb, epilogue)
    got = port_scores(q, cand, bias, qb, cb, epilogue)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(got[~fin], want[~fin])
    tol = score_bound(q, cand, qb, cb, bias, epilogue)
    assert (np.abs(got[fin] - want[fin].astype(np.float64)) <= tol[fin]).all()


def test_kge_score_ref_optional_biases_equal_jax_ref():
    """``ref.kge_score_ref`` skips missing biases as the JAX reference
    does."""
    rng = np.random.default_rng(3)
    q, cand = grid(rng, (4, 6)), grid(rng, (11, 6))
    qb = grid(rng, (4,))
    for epilogue in ("bilinear", "neg_l2"):
        want = np.asarray(jref.kge_score_ref(
            jnp.asarray(q), jnp.asarray(cand), q_bias=jnp.asarray(qb),
            epilogue=epilogue))
        got = ref.kge_score_ref(torch.from_numpy(q), torch.from_numpy(cand),
                                q_bias=torch.from_numpy(qb),
                                epilogue=epilogue).numpy()
        assert np.array_equal(got, want)


def test_kge_score_rejects_unknown_epilogue_and_devices():
    """A wrapper runs the plain version only for CPU tensors; any other
    device than CPU or CUDA, or a mix of devices, raises."""
    q, c = torch.zeros(2, 4), torch.zeros(3, 4)
    bias, qb, cb = torch.zeros(2, 3), torch.zeros(2), torch.zeros(3)
    with pytest.raises(ValueError):
        kge_score(q, c, bias, qb, cb, epilogue="cosine")
    with pytest.raises(ValueError):
        kge_score(q.to("meta"), c.to("meta"), bias.to("meta"),
                  qb.to("meta"), cb.to("meta"))
    with pytest.raises(ValueError):
        topk_scores(torch.zeros(2, 3, device="meta"), 1)
    with pytest.raises(ValueError):
        fused_gather(torch.zeros(4, 2), torch.zeros(1, dtype=torch.int64,
                                                     device="meta"),
                     torch.ones(1, dtype=torch.bool))


def v1_operands(name):
    """Small CPU operands of each first kernel's wrapper."""
    if name == "kge_score_v1":
        return (torch.zeros(2, 4), torch.zeros(3, 4), torch.zeros(2, 3),
                torch.zeros(2), torch.zeros(3))
    if name == "fused_gather_v1":
        return (torch.zeros(4, 2), torch.zeros(3, dtype=torch.int64),
                torch.ones(3, dtype=torch.bool))
    if name == "fused_dequant_gather_v1":
        return (torch.zeros(4, 2, dtype=torch.int8), torch.ones(4),
                torch.zeros(3, dtype=torch.int64),
                torch.ones(3, dtype=torch.bool))
    if name == "scatter_add_onehot_v1":
        return (torch.zeros(3, 2), torch.zeros(3, dtype=torch.int64),
                torch.ones(3, dtype=torch.bool), 4)
    if name == "wkv_chunked_v1":
        return (torch.zeros(2, 5, 4), torch.zeros(2, 5, 4),
                torch.zeros(2, 5, 4), torch.zeros(2, 5, 4), torch.zeros(2, 4))
    if name == "segment_sum_v1":
        return (torch.zeros(5, 3), torch.zeros(5, dtype=torch.int64),
                torch.ones(5, dtype=torch.bool), 4)
    if name == "topk_scores_v1":
        return (torch.zeros(2, 5), 3)
    return (torch.zeros(5, 3), torch.zeros(5, 2), torch.zeros(2, 3, 4),
            torch.ones(5, dtype=torch.bool))


@pytest.mark.parametrize("wrapper", [kge_score_v1, fused_gather_v1,
                                     basis_message_v1, scatter_add_onehot_v1,
                                     wkv_chunked_v1, segment_sum_v1,
                                     topk_scores_v1,
                                     fused_dequant_gather_v1],
                         ids=lambda w: w.__name__)
def test_first_kernels_refuse_cpu_tensors(wrapper):
    """The first kernels, kept as the redesigned kernels' bitwise
    yardsticks on the card, launch on CUDA tensors only: on CPU tensors
    they raise instead of running the plain version, so a comparison
    against them can never compare the plain version with itself."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wrapper(*v1_operands(wrapper.__name__))


# ---------------------------------------------------------------------- #
# topk
# ---------------------------------------------------------------------- #
def tie_heavy_scores(rng, b=6, c=40):
    s = grid(rng, (b, c), -4, 4)          # 9 distinct values: many ties
    s[:, 11] = s[:, 3]
    s[2] = 1.0                            # an all-equal row
    s[3] = -np.inf                        # an all--inf row
    s[4, ::2] = -np.inf                   # half -inf
    s[5, 1::3] = np.float32(-1e9)         # filtered candidates
    return s


def same_bits(got: torch.Tensor, want) -> bool:
    """Values equal bit for bit (``-0.0`` differs from ``+0.0``)."""
    want = np.asarray(want, np.float32)
    return got.shape == want.shape and np.array_equal(
        got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k", [1, 3, 17, 40])
def test_topk_equals_pallas_kernel_and_lax(k):
    """Values (bit for bit) and indices equal the Pallas kernel's and
    ``jax.lax.top_k``'s (ties to the lowest index, -inf drained in index
    order, k = C). These inputs hold no -0.0: at a tie of signed zeros
    ``jax.lax.top_k`` orders +0.0 above -0.0 and so picks other indices
    than the reference's kernel, which the port follows (see
    ``test_topk_signed_zero_ties_equal_the_pallas_kernel``)."""
    s = tie_heavy_scores(np.random.default_rng(k))
    kv, ki = jops.topk_padded(jnp.asarray(s), k, use_kernel=True,
                              interpret=True)
    lv, li = jax.lax.top_k(jnp.asarray(s), k)
    gv, gi = topk_scores(torch.from_numpy(s), k)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int64
    for want_v, want_i in ((kv, ki), (lv, li)):
        assert same_bits(gv, want_v)
        assert np.array_equal(gi.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", [1, 5, 12])
def test_merge_topk_equals_jax_merge(k):
    """The shard merge picks the lowest concat position among equal values
    and returns that position's id, as the JAX merge does; values bit for
    bit."""
    rng = np.random.default_rng(11 + k)
    vals = grid(rng, (4, 12), -2, 2)
    vals[1, ::3] = -np.inf
    ids = rng.permutation(1000)[:48].reshape(4, 12).astype(np.int64)
    jv, ji = jops.merge_topk(jnp.asarray(vals), jnp.asarray(ids, jnp.int32),
                             k)
    gv, gi = ops.merge_topk(torch.from_numpy(vals), torch.from_numpy(ids), k)
    assert same_bits(gv, jv)
    assert np.array_equal(gi.numpy(), np.asarray(ji))


def signed_zero_rows(c=12):
    """Rows whose top entries tie at zero with both signs: -0.0 before
    +0.0, +0.0 before -0.0, only -0.0 left after the last +0.0, and zeros
    among -inf and -1e9 (filtered candidates)."""
    z, p, n, f = -0.0, 0.0, -np.inf, np.float32(-1e9)
    rows = [
        [z, p, z, 1.0, z, z, -1, -1, f, n, z, -2],   # a +0.0 among -0.0
        [z, z, z, p, -1, -1, -1, -1, -1, -1, -1, -1],  # -0.0 before +0.0
        [p, z, z, z, -1, -1, -1, -1, -1, -1, -1, -1],  # +0.0 before -0.0
        [z, p, z, z, z, 2.0, z, -1, z, -1, -1, -1],    # only -0.0 left
        [n, z, f, p, n, z, f, n, z, n, f, n],          # among -inf, -1e9
        [n, n, z, n, f, f, z, n, n, n, n, z],          # no +0.0 at all
        [p, p, z, p, z, n, f, p, z, z, n, z],          # +0.0 then -0.0 last
        [f, f, f, p, f, z, f, n, n, n, n, n],          # zeros above -1e9
    ]
    return np.array([r[:c] for r in rows], np.float32)


@pytest.mark.parametrize("k", [1, 3, 6, 12])
def test_topk_signed_zero_ties_equal_the_pallas_kernel(k):
    """At ties of signed zeros ``topk_scores`` and ``topk_plain`` give the
    reference's value bits and indices: the Pallas kernel's (interpret
    mode) and ``repro.kernels.ref.topk_ref``'s. A round's value is the
    reference's max over the active columns, where +0.0 wins over -0.0."""
    s = signed_zero_rows()
    kv, ki = jops.topk_padded(jnp.asarray(s), k, use_kernel=True,
                              interpret=True)
    rv, ri = jref.topk_ref(jnp.asarray(s), k)
    for fn in (topk_scores, topk_plain):
        gv, gi = fn(torch.from_numpy(s), k)
        for want_v, want_i in ((kv, ki), (rv, ri)):
            assert same_bits(gv, want_v)
            assert np.array_equal(gi.numpy(), np.asarray(want_i))


def test_topk_signed_zero_rule_on_one_row():
    """The row ``[-0, +0, -0, 1, -0, -0, -1, -1]``, k = 3: values
    ``[1, +0, +0]`` at indices ``[3, 0, 1]`` (the second zero round still
    has the +0.0 at index 1 active; the first takes index 0)."""
    s = np.array([[-0.0, 0.0, -0.0, 1.0, -0.0, -0.0, -1, -1]], np.float32)
    gv, gi = topk_plain(torch.from_numpy(s), 3)
    assert same_bits(gv, [[1.0, 0.0, 0.0]])
    assert gi.tolist() == [[3, 0, 1]]
    gv, gi = topk_plain(torch.from_numpy(s), 5)
    # after index 1 no +0.0 is left: the later zeros are -0.0
    assert same_bits(gv, [[1.0, 0.0, 0.0, -0.0, -0.0]])
    assert gi.tolist() == [[3, 0, 1, 2, 4]]


@pytest.mark.parametrize("k", [1, 4, 9])
def test_merge_topk_signed_zero_ties_equal_the_jax_merge(k, monkeypatch):
    """The shard merge at ties of signed zeros: values bit for bit and ids
    of ``repro.kernels.ops.merge_topk`` run through its Pallas kernel
    (interpret mode), as it runs on the TPU. On the CPU that merge
    dispatches to ``jax.lax.top_k``, whose signed-zero order differs from
    the kernel's (see ``test_topk_equals_pallas_kernel_and_lax``), so the
    test routes it to the kernel. "Position" is the position in the
    concatenated row."""
    rng = np.random.default_rng(40 + k)
    vals = signed_zero_rows()
    ids = np.stack([rng.permutation(5000)[:vals.shape[1]]
                    for _ in range(vals.shape[0])]).astype(np.int64)
    kernel_topk = jops.topk_padded
    monkeypatch.setattr(jops, "topk_padded", lambda v, k, interpret=None:
                        kernel_topk(v, k, use_kernel=True, interpret=True))
    jv, ji = jops.merge_topk(jnp.asarray(vals), jnp.asarray(ids, jnp.int32),
                             k)
    gv, gi = ops.merge_topk(torch.from_numpy(vals), torch.from_numpy(ids), k)
    assert same_bits(gv, jv)
    assert np.array_equal(gi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("b,c,sms,want", [
    (8, 14541, 132, 4), (8, 3636, 132, 1), (8, 40, 132, 1),
    (8, 2927963, 132, 66), (1, 2927963, 132, 528), (1, 1, 132, 1),
    (300, 2927963, 132, 2)])
def test_stream_splits(b, c, sms, want):
    """The streaming kernel's blocks a row: one per ``STREAM_SPAN``
    positions, capped so that the grid holds ``STREAM_BLOCKS_PER_SM`` (4)
    blocks an SM, one wave, never more than C."""
    assert stream_splits(b, c, sms) == want


def test_topk_plain_is_the_reference_oracle():
    """``ref.topk_ref`` is the plain version; it agrees with the JAX
    oracle on values and indices."""
    s = tie_heavy_scores(np.random.default_rng(5))
    rv, ri = jref.topk_ref(jnp.asarray(s), 9)
    gv, gi = ref.topk_ref(torch.from_numpy(s), 9)
    assert ref.topk_ref is topk_plain
    assert same_bits(gv, rv)
    assert np.array_equal(gi.numpy(), np.asarray(ri))


def test_topk_k_out_of_range_raises():
    s = torch.zeros(2, 6)
    for k in (0, 7):
        with pytest.raises(ValueError):
            ops.topk_padded(s, k)
        with pytest.raises(ValueError):
            ops.merge_topk(s, torch.zeros(2, 6, dtype=torch.int64), k)


# ---------------------------------------------------------------------- #
# fused gather
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_fused_gather_bitwise_equals_pallas_kernel(shards):
    """Duplicate ids and unowned (dedup padding) slots: the plain version
    is bitwise the Pallas kernel's output, and the plan collapse and the
    fused sharded gather match the JAX ones and the take → mask → sum
    chain."""
    from repro.sharding.embedding import (
        ShardedTableLayout as JLayout, plan_local_gather as j_plan,
    )
    from repro_torch.sharding.embedding import (
        ShardedTableLayout, plan_local_gather,
    )
    rng = np.random.default_rng(shards)
    n, d = 23, 6
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[4] = -0.0                          # signed zeros survive the copy
    ids = np.array([4, 0, 22, 4, -1, 13, 22, 5, -1, 9])   # -1: unowned
    layout = ShardedTableLayout(n, shards)
    rows = layout.rows_per_shard
    li, ow = plan_local_gather(layout, ids)
    jli, jow = j_plan(JLayout(n, shards), ids)
    assert np.array_equal(li, jli) and np.array_equal(ow, jow)

    table = np.zeros((shards * rows, d), np.float32)
    table[:n] = emb
    flat, any_owned = ops.flat_gather_plan(torch.from_numpy(li),
                                           torch.from_numpy(ow), rows)
    jflat, jany = jops.flat_gather_plan(jnp.asarray(li), jnp.asarray(ow),
                                        rows)
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    assert np.array_equal(any_owned.numpy(), np.asarray(jany))

    want = np.asarray(jax_fused_gather(jnp.asarray(table), jflat, jany,
                                       interpret=True))
    got = fused_gather(torch.from_numpy(table), flat, any_owned).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))

    stack = torch.from_numpy(table.reshape(shards, rows, d))
    fused = ops.fused_sharded_gather(stack, torch.from_numpy(li),
                                     torch.from_numpy(ow)).numpy()
    chain = ref.sharded_gather_ref(stack, torch.from_numpy(li).long(),
                                   torch.from_numpy(ow)).numpy()
    jchain = np.asarray(jref.sharded_gather_ref(
        jnp.asarray(table.reshape(shards, rows, d)), jnp.asarray(li),
        jnp.asarray(ow)))
    assert np.array_equal(fused.view(np.int32), want.view(np.int32))
    assert np.array_equal(chain, jchain)
    assert np.array_equal(fused, chain)


def test_fused_gather_flat_id_outside_table_raises():
    """A flat id past the table's rows is a broken plan: the gather raises
    an ``IndexError`` (the kernel's wrapper does the same on the card)."""
    table = torch.zeros(5, 3)
    flat = torch.tensor([0, 5], dtype=torch.int64)
    with pytest.raises(IndexError):
        fused_gather(table, flat, torch.ones(2, dtype=torch.bool))
