"""The PyTorch port's serving slice (``repro_torch``) against the JAX
package's, on the CPU.

The port's ``ShardedKGEServer`` and ``KGEServeEngine`` start from the same
weights as ``repro.serving.ShardedKGEServer`` (handed over through
``repro_torch.convert.from_jax``) and must answer the same top-k. Every
input is drawn with numpy from a fixed seed.

Tolerances: the entity table and the relation tables of distmult, complex
and transe are multiples of 1/8 in [-1, 1], so every fp32 product and sum
on the way to a score is exact and scores are ``==``. RotatE's query goes
through cos/sin of a random phase, which XLA and PyTorch may round a unit
apart; its scores are compared within ``rtol = atol = 1e-5`` (a few fp32
ulps of the O(1) distances, propagated through the norm expansion), and
its indices must still be ``==``.

The int8 server is fed a table of multiples of 1/256 that quantization
rounds (to multiples of 1/64 and finer), so the int8 answers differ from
the fp32 ones; the dequantized values and the 1/8 relation tables still
keep every product and sum exact, so the same gates hold.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import KnowledgeGraph as JKG
from repro.eval.ranking import CSRFilterIndex as JCSR
from repro.eval.ranking import build_filter_index as j_build_filter_index
from repro.eval.sharded import shard_filter_bias_block as j_bias_block
from repro.models.decoders import get_decoder as j_get_decoder
from repro.models.decoders import score_against_candidates as j_scores
from repro.serving import ShardedKGEServer as JServer
from repro.sharding.embedding import ShardedTableLayout as JLayout
from repro.sharding.embedding import plan_unique_gather as j_plan_unique
from repro.sharding.embedding import shard_table as j_shard_table
from repro_torch.convert import from_jax, quantized_table_from_jax
from repro_torch.core.graph import KnowledgeGraph
from repro_torch.eval.ranking import CSRFilterIndex, build_filter_index
from repro_torch.eval.sharded import shard_filter_bias_block
from repro_torch.models.decoders import (
    get_decoder, registered_decoders, row_sum, score_against_candidates,
)
from repro_torch.serving import KGEServeEngine, ShardedKGEServer
from repro_torch.sharding.embedding import (
    ShardedTableLayout, dequantize_rows, plan_unique_gather, quantize_rows,
    shard_table, unshard_table,
)

N_ENT, DIM, N_REL = 57, 8, 3
HEADS = np.array([0, 7, 19, 19, 50])      # duplicates + tied rows
RELS = np.array([0, 1, 2, 2, 0])
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def grid(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


@pytest.fixture(scope="module")
def emb():
    e = grid(np.random.default_rng(0), (N_ENT, DIM))
    e[7] = e[19]          # exact duplicate rows -> exact score ties
    e[40] = e[19]
    return e


def params_for(decoder, seed=0):
    """The decoder's parameter tree as numpy: exact grid values, except
    RotatE's phases."""
    rng = np.random.default_rng(seed)
    shapes = get_decoder(decoder).param_shapes(N_REL, DIM)
    if decoder == "rotate":
        return {k: rng.uniform(-np.pi, np.pi, s).astype(np.float32)
                for k, s in shapes.items()}
    return {k: grid(rng, s) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def graph_arrays():
    rng = np.random.default_rng(1)
    return (rng.integers(0, N_ENT, 400), rng.integers(0, N_REL, 400),
            rng.integers(0, N_ENT, 400))


def port_graph(arrays):
    s, r, t = arrays
    return KnowledgeGraph(src=s, rel=r, dst=t, num_entities=N_ENT,
                          num_relations=N_REL)


def jax_graph(arrays):
    s, r, t = arrays
    return JKG(src=s, rel=r, dst=t, num_entities=N_ENT, num_relations=N_REL)


def port_server(emb, params, decoder, **kw):
    table, p = from_jax(emb, params, decoder=decoder, device="cpu")
    return ShardedKGEServer(table, p, decoder, device="cpu", **kw)


def dense_topk(emb, params, decoder, heads, rels, k, filter_index=None):
    """JAX dense oracle with serving filter semantics (every known tail of
    (h, r) masked)."""
    from repro.eval.ranking import _filter_bias
    scores = np.asarray(j_scores(
        {n: jnp.asarray(v) for n, v in params.items()}, decoder,
        jnp.asarray(emb[heads]), jnp.asarray(np.asarray(rels, np.int32)),
        jnp.asarray(emb)))
    if filter_index is not None:
        batch = np.stack([np.asarray(heads, np.int64),
                          np.asarray(rels, np.int64),
                          np.full(len(heads), -1, np.int64)], axis=1)
        scores = scores + _filter_bias(filter_index, batch, emb.shape[0])
    order = np.lexsort((np.arange(scores.shape[1])[None].repeat(
        len(heads), 0), -scores), axis=1)[:, :k]
    return np.take_along_axis(scores, order, 1), order


# ---------------------------------------------------------------------- #
# the slice as a whole: port server == JAX server
# ---------------------------------------------------------------------- #
_JAX_SERVERS: dict = {}


def jax_server(emb, graph_arrays, decoder, shards):
    """One JAX server per (decoder, shards), shared by the filtered and
    unfiltered cases (its jitted program is the same for both)."""
    key = (decoder, shards)
    if key not in _JAX_SERVERS:
        _JAX_SERVERS[key] = JServer(
            emb, {n: jnp.asarray(v) for n, v in params_for(decoder).items()},
            decoder, num_shards=shards,
            filter_index=JCSR.build([jax_graph(graph_arrays)]))
    return _JAX_SERVERS[key]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("decoder", registered_decoders())
def test_sharded_server_equals_jax_server(emb, graph_arrays, decoder, shards,
                                          filtered):
    """Same weights, same queries: indices ``==`` the JAX server's for
    every decoder, shard count and filter mode; scores ``==`` on exact
    inputs (RotatE: within the stated tolerance)."""
    jv, ji = jax_server(emb, graph_arrays, decoder, shards).topk_tails(
        HEADS, RELS, 11, filtered=filtered)
    srv = port_server(emb, params_for(decoder), decoder, num_shards=shards,
                      filter_index=CSRFilterIndex.build(
                          [port_graph(graph_arrays)]))
    gv, gi = srv.topk_tails(HEADS, RELS, 11, filtered=filtered)
    assert gi.dtype == np.int64 and gv.dtype == np.float32
    assert np.array_equal(gi, ji)
    if decoder == "rotate":
        np.testing.assert_allclose(gv, jv, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(gv, jv)


@pytest.fixture(scope="module")
def emb8():
    """A table that int8 quantization rounds: multiples of 1/256 up to
    about 1.2 in magnitude, rows of different ranges, and duplicate rows
    for exact ties."""
    rng = np.random.default_rng(8)
    e = (rng.integers(-300, 301, (N_ENT, DIM)) / 256.0).astype(np.float32)
    e[::3] /= 8                      # smaller rows take smaller scales
    e[7] = e[19]
    e[40] = e[19]
    return e


_JAX_INT8_SERVERS: dict = {}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("decoder", registered_decoders())
def test_int8_server_equals_jax_server(emb8, graph_arrays, decoder, shards,
                                       filtered):
    """``table_dtype="int8"``: indices ``==`` the JAX int8 server's for
    every decoder, shard count and filter mode (duplicate heads
    included); scores ``==`` (RotatE: within the stated tolerance)."""
    key = (decoder, shards)
    if key not in _JAX_INT8_SERVERS:
        _JAX_INT8_SERVERS[key] = JServer(
            emb8, {n: jnp.asarray(v) for n, v in params_for(decoder).items()},
            decoder, num_shards=shards,
            filter_index=JCSR.build([jax_graph(graph_arrays)]),
            table_dtype="int8")
    jsrv = _JAX_INT8_SERVERS[key]
    jv, ji = jsrv.topk_tails(HEADS, RELS, 11, filtered=filtered)
    srv = port_server(emb8, params_for(decoder), decoder, num_shards=shards,
                      filter_index=CSRFilterIndex.build(
                          [port_graph(graph_arrays)]), table_dtype="int8")
    gv, gi = srv.topk_tails(HEADS, RELS, 11, filtered=filtered)
    # the device holds the reference's codes and scales, bit for bit
    codes, scales = quantized_table_from_jax(
        {"codes": jsrv.table[0], "scales": jsrv.table[1]}, device="cpu")
    assert torch.equal(srv.table[0], codes)
    assert torch.equal(srv.table[1].view(torch.int32),
                       scales.view(torch.int32))
    assert np.array_equal(gi, ji)
    if decoder == "rotate":
        np.testing.assert_allclose(gv, jv, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(gv, jv)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_int8_server_equals_dense_over_dequantized(emb8, graph_arrays,
                                                   shards):
    """Int8 serving == the dense top-k over the dequantized table (through
    the head cache too), and the table takes (d + 4) / (4 d) of the fp32
    bytes."""
    p = params_for("transe", 2)
    dq = dequantize_rows(*quantize_rows(torch.from_numpy(emb8))).numpy()
    assert not np.array_equal(dq, emb8)
    heads, rels = np.array([0, 3, 7, 19, 19]), np.array([0, 1, 2, 2, 0])
    csr = CSRFilterIndex.build([port_graph(graph_arrays)])
    for filtered in (False, True):
        dv, di = dense_topk(dq, p, "transe", heads, rels, 9,
                            JCSR.build([jax_graph(graph_arrays)])
                            if filtered else None)
        for cache in (0, 4):
            srv = port_server(emb8, p, "transe", num_shards=shards,
                              filter_index=csr, cache_size=cache,
                              table_dtype="int8")
            for _ in range(2):            # the second round hits the cache
                sv, si = srv.topk_tails(heads, rels, 9, filtered=filtered)
                assert np.array_equal(si, di) and np.array_equal(sv, dv)
    rows = srv.layout.rows_per_shard
    assert srv.table_bytes == shards * rows * (DIM + 4)
    fp32 = port_server(emb8, p, "transe", num_shards=shards)
    assert fp32.table_bytes == shards * rows * DIM * 4


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_filtered_csr_and_dict_equal_dense(emb, graph_arrays, shards):
    """Filtered serving == dense + serving-sentinel filter bias, for both
    the CSR index and the dict reference form."""
    p = params_for("distmult", 1)
    heads, rels = np.array([0, 3, 7, 19]), np.array([0, 1, 2, 2])
    dv, di = dense_topk(emb, p, "distmult", heads, rels, 9,
                        JCSR.build([jax_graph(graph_arrays)]))
    g = port_graph(graph_arrays)
    for idx in (CSRFilterIndex.build([g]), build_filter_index([g])):
        srv = port_server(emb, p, "distmult", num_shards=shards,
                          filter_index=idx)
        sv, si = srv.topk_tails(heads, rels, 9, filtered=True)
        assert np.array_equal(si, di) and np.array_equal(sv, dv)


# ---------------------------------------------------------------------- #
# host side: filter index, bias blocks, layouts, plans, decoders
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_filter_index_and_bias_blocks_equal_jax(graph_arrays, shards):
    """CSR arrays, column-range bias blocks (sentinel t = -1, -inf layout
    padding) and the dict form equal the JAX package's."""
    g, jg = port_graph(graph_arrays), jax_graph(graph_arrays)
    csr, jcsr = CSRFilterIndex.build([g]), JCSR.build([jg])
    for f in ("keys", "indptr", "tails"):
        assert np.array_equal(getattr(csr, f), getattr(jcsr, f))
    assert build_filter_index([g]) == j_build_filter_index([jg])
    inv, jinv = g.with_inverse_relations(), jg.with_inverse_relations()
    assert inv.num_relations == jinv.num_relations == 2 * N_REL
    assert np.array_equal(inv.triplets(), jinv.triplets())
    batch = np.stack([HEADS, RELS, np.full(5, -1)], axis=1)
    layout, jlayout = ShardedTableLayout(N_ENT, shards), JLayout(N_ENT, shards)
    for s in range(shards):
        got = shard_filter_bias_block(csr, batch, layout, s,
                                      csr.resolve_queries(batch))
        want = j_bias_block(jcsr, batch, jlayout, s)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("shards", [1, 2, 5])
def test_layout_and_unique_plan_equal_jax(emb, shards):
    layout, jlayout = ShardedTableLayout(N_ENT, shards), JLayout(N_ENT, shards)
    assert layout.rows_per_shard == jlayout.rows_per_shard
    for s in range(shards):
        assert layout.shard_row_span(s) == jlayout.shard_row_span(s)
    stack = shard_table(torch.from_numpy(emb), layout)
    assert np.array_equal(stack.numpy(), j_shard_table(emb, jlayout))
    assert np.array_equal(unshard_table(stack, N_ENT).numpy(), emb)
    ids = np.array([5, 5, 56, 0, 31, 5])
    for got, want in zip(plan_unique_gather(layout, ids, 4),
                         j_plan_unique(jlayout, ids, 4)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("decoder", registered_decoders())
def test_decoder_query_form_equals_jax(emb, decoder):
    """prepare_query / prepare_candidates equal the JAX decoders' (exactly
    on grid inputs; RotatE within the stated tolerance)."""
    p = params_for(decoder)
    tp = from_jax(emb, p, decoder=decoder, device="cpu")[1]
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    dec, jdec = get_decoder(decoder), j_get_decoder(decoder)
    h, rel = emb[HEADS], RELS
    q, qb = dec.prepare_query(tp, torch.from_numpy(h), torch.from_numpy(rel))
    jq, jqb = jdec.prepare_query(jp, jnp.asarray(h), jnp.asarray(rel))
    c, cb = dec.prepare_candidates(tp, torch.from_numpy(emb))
    jc, jcb = jdec.prepare_candidates(jp, jnp.asarray(emb))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert np.array_equal(cb.numpy(), np.asarray(jcb))
    # the direct triplet form and the dense matrix-product form
    tails = emb[np.array([3, 7, 40, 0, 56])]
    got_s = dec.score(tp, torch.from_numpy(h), torch.from_numpy(rel),
                      torch.from_numpy(tails)).numpy()
    want_s = np.asarray(jdec.score(jp, jnp.asarray(h), jnp.asarray(rel),
                                   jnp.asarray(tails)))
    got_d = score_against_candidates(tp, decoder, torch.from_numpy(h),
                                     torch.from_numpy(rel),
                                     torch.from_numpy(emb)).numpy()
    want_d = np.asarray(j_scores(jp, decoder, jnp.asarray(h),
                                 jnp.asarray(rel), jnp.asarray(emb)))
    pairs = [(q.numpy(), jq), (qb.numpy(), jqb), (got_s, want_s),
             (got_d, want_d)]
    for got, want in pairs:
        if decoder == "rotate":
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert np.array_equal(got, np.asarray(want))


def test_row_sum_does_not_depend_on_leading_shape():
    """A row's squared norm has the same bits alone, in a block and in the
    full table — what keeps shard blocks bitwise the dense columns."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(300, 75)).astype(np.float32))
    full = row_sum(x)
    assert torch.equal(row_sum(x[100:173]), full[100:173])
    assert torch.equal(row_sum(x[7:8]), full[7:8])


def test_from_jax_checks_shapes_and_dtypes(emb):
    p = params_for("transe")
    table, tp = from_jax(emb, p, decoder="transe", device="cpu")
    assert table.dtype == torch.float32 and np.array_equal(table.numpy(), emb)
    assert np.array_equal(tp["rel_vec"].numpy(), p["rel_vec"])
    with pytest.raises(TypeError):
        from_jax(emb.astype(np.float64), p, device="cpu")
    with pytest.raises(ValueError):
        from_jax(emb[0], p, device="cpu")
    with pytest.raises(ValueError):          # rotate wants (R, d/2)
        from_jax(emb, p, decoder="rotate", device="cpu")
    with pytest.raises(ValueError):          # wrong width for d
        from_jax(emb[:, :6], p, decoder="transe", device="cpu")


# ---------------------------------------------------------------------- #
# server and engine behaviour (mirrors tests/test_serving.py)
# ---------------------------------------------------------------------- #
def test_k_clamps_to_vocab_and_int8_raises(emb):
    """k clamps to the vocabulary and bad arguments raise, for the fp32 and
    (ported since) the int8 table; an unknown table dtype raises."""
    for dtype in ("fp32", "int8"):
        srv = port_server(emb, params_for("distmult"), "distmult",
                          num_shards=2, table_dtype=dtype)
        sv, si = srv.topk_tails(np.array([0]), np.array([0]), k=10 * N_ENT)
        assert si.shape == (1, N_ENT)
        assert sorted(si[0].tolist()) == list(range(N_ENT))
        with pytest.raises(ValueError):
            srv.topk_tails(np.array([0]), np.array([0]), k=0)
        with pytest.raises(ValueError):
            srv.topk_tails(np.array([0]), np.array([0]), filtered=True)
    assert srv.table[0].dtype == torch.int8
    with pytest.raises(ValueError, match="table_dtype"):
        port_server(emb, params_for("distmult"), "distmult",
                    table_dtype="int4")


def test_filtered_masks_all_known_tails(emb, graph_arrays):
    csr = CSRFilterIndex.build([port_graph(graph_arrays)])
    src, rel, _ = graph_arrays
    h, r = int(src[0]), int(rel[0])
    known = set(csr.tails_of(h, r).tolist())
    assert known
    srv = port_server(emb, params_for("distmult", 1), "distmult",
                      num_shards=2, filter_index=csr)
    _, si = srv.topk_tails(np.array([h]), np.array([r]),
                           k=N_ENT - len(known), filtered=True)
    assert not (set(si[0].tolist()) & known)


def test_head_cache_changes_no_bits(emb):
    p = params_for("distmult", 2)
    heads, rels = np.array([5, 5, 19, 5]), np.array([0, 1, 2, 0])
    plain = port_server(emb, p, "distmult", num_shards=2)
    cached = port_server(emb, p, "distmult", num_shards=2, cache_size=16)
    for _ in range(2):                    # the second round is all hits
        pv, pi = plain.topk_tails(heads, rels, 7)
        cv, ci = cached.topk_tails(heads, rels, 7)
        assert np.array_equal(pi, ci) and np.array_equal(pv, cv)
    assert cached.cache_hits > 0 and len(cached._cache) <= 16
    tiny = port_server(emb, p, "distmult", num_shards=2, cache_size=2)
    heads, rels = np.arange(8), np.zeros(8, np.int64)
    pv, pi = plain.topk_tails(heads, rels, 5)
    cv, ci = tiny.topk_tails(heads, rels, 5)   # more uniques than entries
    assert np.array_equal(pi, ci) and np.array_equal(pv, cv)
    assert len(tiny._cache) <= 2


def test_engine_out_of_order_integrity(emb):
    """smallest-k-first completes out of submission order; every response
    equals its own query's dense top-k."""
    p = params_for("distmult", 3)
    eng = KGEServeEngine(port_server(emb, p, "distmult", num_shards=2),
                         slots=3, max_k=9, policy="smallest-k-first")
    rng = np.random.default_rng(4)
    reqs = [eng.submit(int(h), int(r), k=int(k)) for h, r, k in zip(
        rng.integers(0, N_ENT, 10), rng.integers(0, N_REL, 10),
        rng.integers(1, 10, 10))]
    done = eng.run()
    assert len(done) == 10 and all(r.done for r in reqs)
    order = [r.request_id for r in done]
    assert order != sorted(order)
    for r in reqs:
        dv, di = dense_topk(emb, p, "distmult", np.array([r.head]),
                            np.array([r.relation]), r.k)
        assert np.array_equal(r.tails, di[0])
        assert np.array_equal(r.scores, dv[0])


def test_engine_fifo_partial_batches_and_guards(emb):
    p = params_for("distmult", 3)
    srv = port_server(emb, p, "distmult", num_shards=2)
    eng = KGEServeEngine(srv, slots=4, max_k=8)
    reqs = [eng.submit(i % N_ENT, i % N_REL, k=1 + i % 8) for i in range(7)]
    done = eng.run()
    assert [r.request_id for r in done] == [r.request_id for r in reqs]
    assert eng.pending == 0
    for r in reqs:
        _, di = dense_topk(emb, p, "distmult", np.array([r.head]),
                           np.array([r.relation]), r.k)
        assert r.tails.shape == (r.k,) and np.array_equal(r.tails, di[0])
    with pytest.raises(ValueError):
        KGEServeEngine(srv, slots=2, max_k=5).submit(0, 0, k=6)
    with pytest.raises(ValueError):
        eng.submit(0, 0, k=0)
    with pytest.raises(ValueError):
        KGEServeEngine(srv, policy="largest-first")


# ---------------------------------------------------------------------- #
# entry point: device rule; package: import rule
# ---------------------------------------------------------------------- #
SMALL = ["--entities", "300", "--relations", "5", "--dim", "16",
         "--requests", "20", "--table-shards", "3", "--cache-size", "8"]


def test_serve_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedKGEServer(np.zeros((4, 2), np.float32),
                         {"rel_diag": np.zeros((1, 2), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax(np.zeros((4, 2), np.float32),
                 {"rel_diag": np.zeros((1, 2), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL + ["--table-dtype", "int8"])
    # on the CPU the int8 server runs and passes its equality check
    assert serve.run(serve.parse_args(
        SMALL + ["--device", "cpu", "--table-dtype", "int8"]))["equal_dense"]


@pytest.mark.parametrize("decoder,flags", [
    ("distmult", []), ("transe", ["--filtered"]),
    ("rotate", ["--filtered", "--policy", "smallest-k-first"]),
    ("complex", ["--filtered", "--table-dtype", "int8"])])
def test_serve_cli_on_cpu_passes_its_equality_check(decoder, flags, capsys):
    from repro_torch.launch import serve
    serve.main(SMALL + ["--device", "cpu", "--decoder", decoder] + flags)
    out = capsys.readouterr().out
    assert "sharded top-k == dense top-k: True" in out
    assert "device=cpu" in out


def test_chip_smoke_fails_without_cuda():
    """With no CUDA device visible, chip_smoke.py exits non-zero and prints
    no result line."""
    root = os.path.join(SRC, "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=root)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert "no CUDA device" in res.stderr


def _module_files():
    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(SRC, "..", "chip_smoke.py")


def test_port_never_imports_jax_or_the_reference():
    """Statically, no module of repro_torch nor chip_smoke.py imports jax
    or repro (lazy imports inside functions included); at run time,
    importing every module in a fresh interpreter loads neither."""
    for path in _module_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120,
                         cwd=os.path.join(SRC, ".."))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")
