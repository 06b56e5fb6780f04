"""The port's int8 entity table (``repro_torch.sharding.embedding``'s
quantization, the ``fused_dequant_gather`` kernel's plain version,
``kernels.ops``' int8 gathers, ``kernels.ref``'s oracles) against the JAX
package's, on the CPU.

* Quantization is bitwise the reference's: the port's ``quantize_rows``
  and its oracle ``quantize_rows_ref`` give the same codes and scales as
  ``repro``'s ``quantize_rows`` and ``ref.quantize_rows_ref`` on tables
  whose magnitudes sweep the whole fp32 range, subnormals included (the
  sweep of ``tests/test_quantized_table.py``), and on the edge rows.
* The dequantizing gather is bitwise ``repro``'s Pallas kernel (interpret
  mode) and its oracle at 1, 2, 4 and 8 shards.
* The straight-through training gather: forward bitwise ``repro``'s
  ``sharded_gather(table_dtype="int8")``; master gradients bitwise the
  port's own fp32 path on the dequantized master; gradients against
  ``repro``'s within twice ``gamma_n Σ|g|`` per element (``n`` the row's
  hit count), the bound ``tests/test_torch_sharded.py`` holds the fp32
  gradients to, since the two sides add each row's cotangents in other
  orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels import ref as jref
from repro.kernels.ops import dequant_sharded_gather as j_dequant_gather
from repro.sharding import embedding as jemb
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sharded_gather import (
    fused_dequant_gather, fused_dequant_gather_plain,
)
from repro_torch.models.kge import KGEConfig, vertex_input
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.sharding import (
    INT8_QMAX, QuantizedTableLayout, ShardedTableLayout, dequantize_rows,
    dequantize_table, plan_local_gather, plan_unique_gather, quantize_rows,
    quantize_table, shard_table, sharded_dequant_gather, sharded_gather,
    unshard_table,
)

U32 = 2.0 ** -24
F32_MAX = np.finfo(np.float32).max


def gamma(n):
    return n * U32 / (1 - n * U32)


def bits(t) -> np.ndarray:
    a = t.detach().contiguous().numpy() if isinstance(t, torch.Tensor) \
        else np.ascontiguousarray(np.asarray(t))
    return a.view(np.int32) if a.dtype == np.float32 else a


def sweep_table(seed, rows, d, emin, emax, zero_row):
    """Random fp32 rows whose magnitudes span ``2^[emin, emax]`` (the
    reference suite's generator): the exponent sweep reaches the
    subnormal-scale and near-overflow branches of the quantizer."""
    rng = np.random.default_rng(seed)
    lo, hi = sorted((emin, emax))
    with np.errstate(over="ignore"):        # 2^128 and up become inf
        x = (rng.choice([-1.0, 1.0], (rows, d))
             * rng.uniform(1.0, 2.0, (rows, d))
             * np.exp2(rng.uniform(lo, hi, (rows, d)))).astype(np.float32)
    if zero_row:
        x[0] = 0.0
    return x


def assert_quantization_equals_reference(x):
    jc, js = jemb.quantize_rows(x)
    rc, rs = jref.quantize_rows_ref(jnp.asarray(x))
    t = torch.from_numpy(x)
    for codes, scales in (quantize_rows(t), ref.quantize_rows_ref(t)):
        assert codes.dtype == torch.int8 and scales.dtype == torch.float32
        for want_c, want_s in ((jc, js), (rc, rs)):
            np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
            np.testing.assert_array_equal(bits(scales), bits(want_s))


# ---------------------------------------------------------------------- #
# quantization
# ---------------------------------------------------------------------- #
@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(1, 16),
       d=st.integers(1, 33), emin=st.integers(-150, 127),
       emax=st.integers(-150, 127), zero_row=st.booleans())
def test_property_quantize_rows_equals_reference_bitwise(seed, rows, d, emin,
                                                         emax, zero_row):
    x = sweep_table(seed, rows, d, emin, emax, zero_row)
    x[np.isinf(x)] = np.copysign(F32_MAX, x[np.isinf(x)])
    assert_quantization_equals_reference(x)


def _boundary_rows():
    """Rows whose amax is exactly ``127 · 2^k`` (code 127 at scale 2^k) or
    one ulp above it (the next scale), for normal and subnormal k."""
    out = []
    for k in (-149, -140, -127, -126, -20, 0, 20, 120):
        t = np.float32(127.0) * np.ldexp(np.float32(1.0), k)
        out.append([t, -t / 3, 0.0])
        out.append([np.nextafter(t, np.float32(np.inf)), t / 2, -0.0])
    return np.array(out, np.float32)


EDGE_CASES = {
    "all_zero": np.zeros((3, 5), np.float32),
    "signed_zeros": np.array([[0.0, -0.0, 0.0], [-0.0, -0.0, -0.0],
                              [1.0, -0.0, 0.0]], np.float32),
    "largest_finite": np.array([[F32_MAX, -F32_MAX, 1.0],
                                [-F32_MAX, 0.0, F32_MAX / 3]], np.float32),
    "subnormals": np.array(
        [[1e-45, -1e-45, 0.0], [3e-39, -1e-40, 2e-45],
         [1.1754942e-38, 1.1754944e-38, -5e-39]], np.float32),
    "near_127_2k": _boundary_rows(),
    "single_element": np.array([[3.0], [-1e-44], [0.0], [F32_MAX]],
                               np.float32),
    "half_ties": np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5],
                           [254.0, 1.0, 3.0, 5.0, -1.0, -3.0]], np.float32),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_quantize_rows_edge_rows_equal_reference(case):
    assert_quantization_equals_reference(EDGE_CASES[case])


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(1, 12),
       d=st.integers(1, 33), emin=st.integers(-150, 35),
       emax=st.integers(-150, 35), zero_row=st.booleans())
def test_property_round_trip_within_half_scale(seed, rows, d, emin, emax,
                                               zero_row):
    x = sweep_table(seed, rows, d, emin, emax, zero_row)
    codes, scales = quantize_rows(torch.from_numpy(x))
    assert (codes.int().abs() <= INT8_QMAX).all()
    err = (dequantize_rows(codes, scales).double()
           - torch.from_numpy(x).double()).abs()
    assert (err <= scales.double()[:, None] / 2).all()
    zero = (torch.from_numpy(x) == 0).all(dim=1)
    assert (scales[zero] == 0).all() and (codes[zero] == 0).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(1, 12),
       d=st.integers(1, 17), emin=st.integers(-150, 35),
       emax=st.integers(-150, 35))
def test_property_quantization_idempotent(seed, rows, d, emin, emax):
    x = torch.from_numpy(sweep_table(seed, rows, d, emin, emax, False))
    codes, scales = quantize_rows(x)
    codes2, scales2 = quantize_rows(dequantize_rows(codes, scales))
    assert torch.equal(codes, codes2)
    assert torch.equal(scales.view(torch.int32), scales2.view(torch.int32))


def test_stacked_table_quantizes_row_by_row():
    """An ``(S, rows, d)`` stack quantizes as its flat rows do, and the
    dict form round-trips through ``convert`` bitwise in both directions."""
    x = sweep_table(3, 12, 9, -30, 10, True)
    layout = ShardedTableLayout(12, 4)
    stack = shard_table(torch.from_numpy(x), layout)
    q = quantize_table(stack)
    assert q["codes"].shape == (4, 3, 9) and q["scales"].shape == (4, 3)
    flat_c, flat_s = quantize_rows(stack.reshape(12, 9))
    assert torch.equal(q["codes"].reshape(12, 9), flat_c)
    assert torch.equal(q["scales"].reshape(12), flat_s)
    assert torch.equal(dequantize_table(q), dequantize_rows(
        q["codes"], q["scales"]))
    jq = jemb.quantize_table(np.asarray(jemb.shard_table(
        x, jemb.ShardedTableLayout(12, 4))))
    codes, scales = convert.quantized_table_from_jax(jq, device="cpu")
    assert torch.equal(codes, q["codes"])
    assert torch.equal(scales.view(torch.int32), q["scales"].view(
        torch.int32))
    back = convert.quantized_table_to_jax(codes, scales)
    for k in ("codes", "scales"):
        assert back[k].dtype == jq[k].dtype
        assert back[k].tobytes() == np.asarray(jq[k]).tobytes()
    with pytest.raises(TypeError, match="int8"):
        convert.quantized_table_from_jax(
            {"codes": np.zeros((2, 3), np.int16),
             "scales": np.zeros(2, np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="not"):
        convert.quantized_table_from_jax(
            {"codes": np.zeros((2, 3), np.int8),
             "scales": np.zeros(3, np.float32)}, device="cpu")


@pytest.mark.parametrize("v,s", [(20_000, 1), (14_541, 4), (64, 8)])
def test_layout_bytes_equal_reference(v, s):
    q, f = QuantizedTableLayout(v, s), ShardedTableLayout(v, s)
    jq, jf = jemb.QuantizedTableLayout(v, s), jemb.ShardedTableLayout(v, s)
    for d in (32, 64, 75):
        assert q.bytes_per_shard(d) == jq.bytes_per_shard(d)
        assert f.bytes_per_shard(d) == jf.bytes_per_shard(d)
        ratio = q.bytes_per_shard(d) / f.bytes_per_shard(d)
        assert ratio == pytest.approx((d + 4) / (4 * d))
    assert q.rows_per_shard == f.rows_per_shard == jq.rows_per_shard


# ---------------------------------------------------------------------- #
# the dequantizing gather
# ---------------------------------------------------------------------- #
def gather_case(s, n=301, d=11, seed=0):
    """A quantized stack (codes from the reference's quantizer) and global
    ids with duplicates, boundary rows (0, n-1, each shard's first and
    last row) and, through the dedup plan, unowned padding slots."""
    rng = np.random.default_rng(seed + s)
    x = sweep_table(seed + s, n, d, -30, 5, True)
    x[7] = 0.0
    layout = ShardedTableLayout(n, s)
    jcodes, jscales = jemb.quantize_rows(np.asarray(jemb.shard_table(
        x, jemb.ShardedTableLayout(n, s))))
    rows = layout.rows_per_shard
    edges = [0, n - 1, 7] + [min(n - 1, b * rows + o) for b in range(s)
                             for o in (0, rows - 1)]
    ids = np.concatenate([rng.integers(0, n, 40), edges])
    ids[::6] = ids[1]                       # a hot duplicate id
    return layout, jcodes, jscales, ids


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_dequant_gather_equals_reference_kernel_and_oracle(s):
    layout, jcodes, jscales, ids = gather_case(s)
    codes, scales = torch.from_numpy(jcodes), torch.from_numpy(jscales)
    for dedup in (False, True):
        if dedup:
            local, owned, inverse = plan_unique_gather(layout, ids, 16)
            assert not owned.any(axis=0).all()   # unowned padding slots
        else:
            (local, owned), inverse = plan_local_gather(layout, ids), None
        jl, jo = jnp.asarray(local), jnp.asarray(owned)
        want_kernel = np.asarray(j_dequant_gather(
            jnp.asarray(jcodes), jnp.asarray(jscales), jl, jo,
            use_kernel=True, interpret=True))
        want_oracle = np.asarray(jref.dequant_gather_ref(
            jnp.asarray(jcodes), jnp.asarray(jscales), jl, jo))
        lt, ot = torch.from_numpy(local), torch.from_numpy(owned)
        got = ops.dequant_sharded_gather(codes, scales, lt, ot)
        flat, anyo = ops.flat_gather_plan(lt, ot, layout.rows_per_shard)
        got_plain = fused_dequant_gather_plain(
            codes.reshape(-1, codes.shape[-1]), scales.reshape(-1), flat,
            anyo)
        got_ref = ref.dequant_gather_ref(codes, scales, lt, ot)
        for g in (got, got_plain, got_ref):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(bits(g), bits(want_kernel))
            np.testing.assert_array_equal(bits(g), bits(want_oracle))
        # unowned padding slots are exact +0 rows
        assert (bits(got)[~anyo.numpy()] == 0).all()
        # through the public gather: the slots in batch order, bitwise
        # the dense gather of the dequantized table
        rows = sharded_dequant_gather(codes, scales, local, owned,
                                      inverse=inverse)
        dense = unshard_table(dequantize_rows(codes, scales),
                              layout.num_rows)
        np.testing.assert_array_equal(bits(rows), bits(dense[ids]))


def test_dequant_gather_subnormal_and_zero_scales():
    """Rows with the smallest scales (2^-149 … 2^-127) and all-zero rows
    come through as the exact products ``code · scale``."""
    x = np.array([[1e-45, -1e-45, 0.0], [3e-39, -1e-40, 2e-45],
                  [0.0, 0.0, 0.0], [1.0, -0.5, 0.25], [-0.0, 0.0, -0.0]],
                 np.float32)
    codes, scales = quantize_rows(torch.from_numpy(x))
    assert float(scales[0]) == 2.0 ** -149 and float(scales[2]) == 0.0
    flat = torch.tensor([0, 1, 2, 3, 4, 0])
    got = fused_dequant_gather(codes, scales, flat,
                               torch.tensor([True] * 5 + [False]))
    want = dequantize_rows(codes, scales)[flat[:5]]
    np.testing.assert_array_equal(bits(got[:5]), bits(want))
    np.testing.assert_array_equal(bits(got[:1]), bits(x[:1]))  # exact row
    assert (bits(got[5]) == 0).all()


def test_dequant_gather_flat_id_outside_table_raises_on_cpu():
    codes = torch.zeros((4, 2), dtype=torch.int8)
    scales = torch.ones(4)
    for check in (True, False):
        with pytest.raises(IndexError):
            fused_dequant_gather(codes, scales, torch.tensor([1, 4]),
                                 torch.tensor([True, True]), check=check)


# ---------------------------------------------------------------------- #
# the straight-through training gather (mirrors TestQuantizedGatherSweep)
# ---------------------------------------------------------------------- #
N, D = 301, 16
IDS = np.array([5, 3, 5, 0, N - 1, 3, 299, 150, 150, 7, 0, N - 1, 42])
W = np.arange(1.0, D + 1, dtype=np.float32)


def master(s):
    table = np.array(jax.random.normal(jax.random.PRNGKey(4), (N, D)),
                     np.float32)
    layout = ShardedTableLayout(N, s)
    local, owned = plan_local_gather(layout, IDS)
    return table, layout, local, owned


def port_loss_grad(stack, local, owned, dtype, **kw):
    t = stack.clone().requires_grad_()
    out = sharded_gather(t, local, owned, table_dtype=dtype, **kw)
    loss = (torch.tanh(out) * torch.from_numpy(W)).sum()
    loss.backward()
    return out.detach(), loss.detach(), t.grad


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_quantized_gather_forward_equals_reference(s):
    table, layout, local, owned = master(s)
    jstack = jemb.shard_table(jnp.asarray(table),
                              jemb.ShardedTableLayout(N, s))
    want = np.asarray(jemb.sharded_gather(
        jstack, jnp.asarray(local), jnp.asarray(owned), table_dtype="int8"))
    stack = shard_table(torch.from_numpy(table), layout)
    got = sharded_gather(stack, local, owned, table_dtype="int8")
    np.testing.assert_array_equal(bits(got), bits(want))
    # within scale/2 of the fp32 rows
    _, scales = quantize_rows(torch.from_numpy(table))
    err = (got.double() - torch.from_numpy(table[IDS]).double()).abs()
    assert (err <= scales.double()[IDS][:, None] / 2).all()


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("variant", ["fused", "masked_sum", "dedup"])
def test_master_grads_bitwise_fp32_path_on_dequant(s, variant):
    table, layout, local, owned = master(s)
    stack = shard_table(torch.from_numpy(table), layout)
    dq = dequantize_rows(*quantize_rows(stack))
    kw = {"exchange": variant} if variant != "dedup" else {}
    if variant == "dedup":
        local, owned, inverse = plan_unique_gather(layout, IDS, 8)
        kw = {"inverse": inverse}
    out_q, loss_q, grad_q = port_loss_grad(stack, local, owned, "int8", **kw)
    out_f, loss_f, grad_f = port_loss_grad(dq, local, owned, "fp32", **kw)
    np.testing.assert_array_equal(bits(out_q), bits(out_f))
    assert loss_q.item() == loss_f.item()
    np.testing.assert_array_equal(bits(grad_q), bits(grad_f))
    assert (grad_q.reshape(-1, D)[N:] == 0).all()   # layout padding


@pytest.mark.parametrize("s", [1, 2, 4])
def test_loss_and_grads_near_reference(s):
    """A loss linear in the gathered rows, so both sides scatter the same
    cotangents ``up`` into the master rows, in other orders."""
    table, layout, local, owned = master(s)
    up = np.random.default_rng(s).standard_normal(
        (len(IDS), D)).astype(np.float32)
    jstack = jemb.shard_table(jnp.asarray(table),
                              jemb.ShardedTableLayout(N, s))
    jl, jo = jnp.asarray(local), jnp.asarray(owned)
    want_loss, want_grad = jax.value_and_grad(lambda t: jnp.sum(
        jemb.sharded_gather(t, jl, jo, table_dtype="int8")
        * jnp.asarray(up)))(jstack)
    t = shard_table(torch.from_numpy(table), layout).requires_grad_()
    loss = (sharded_gather(t, local, owned, table_dtype="int8")
            * torch.from_numpy(up)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    # within twice gamma_n Σ|g| of each other; the row-block layout puts
    # global id g at flat row g
    absum = np.zeros((layout.padded_rows, D))
    np.add.at(absum, IDS, np.abs(up.astype(np.float64)))
    hits = np.bincount(IDS, minlength=layout.padded_rows)[:, None]
    diff = np.abs(t.grad.reshape(-1, D).numpy()
                  - np.asarray(want_grad).reshape(-1, D))
    assert (diff <= 2 * gamma(hits) * absum).all()


def test_vertex_input_int8_dense_master_is_one_shard_stack():
    """A dense ``(N, d)`` int8 master gathers as a one-shard stack: the
    same rows and table gradient as the 2-shard stack's, bitwise."""
    table, _, _, _ = master(1)
    ids = torch.from_numpy(IDS)
    outs, grads = [], []
    for s in (1, 2):
        cfg = KGEConfig(RGCNConfig(num_entities=N, num_relations=4,
                                   hidden_dim=D, num_table_shards=s,
                                   table_dtype="int8"))
        t = torch.from_numpy(table)
        t = (t if s == 1 else shard_table(t, ShardedTableLayout(N, s))
             ).clone().requires_grad_()
        out = vertex_input({"entity_embedding": t}, cfg, ids, None)
        (torch.tanh(out) * torch.from_numpy(W)).sum().backward()
        outs.append(out.detach())
        grads.append(t.grad if s == 1 else unshard_table(t.grad, N))
    assert grads[0].shape == (N, D)
    np.testing.assert_array_equal(bits(outs[0]), bits(outs[1]))
    np.testing.assert_array_equal(bits(grads[0]), bits(grads[1]))
    fp32 = ops.gather_rows(torch.from_numpy(table), ids)
    assert not torch.equal(outs[0], fp32)     # the rows really are int8


def test_unknown_table_dtype_rejected():
    table, _, local, owned = master(1)
    with pytest.raises(ValueError, match="table_dtype"):
        sharded_gather(torch.from_numpy(table)[None], local, owned,
                       table_dtype="int4")
