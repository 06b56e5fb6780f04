"""The PyTorch port's RGCN encoder against the JAX package's, on the CPU:
the two RGCN kernels' plain versions (the JAX side runs the Pallas kernels
in interpret mode), the fused message op with its gradients, and the
encoder for every decomposition with the kernel path on and off.

Inputs are drawn with numpy from fixed seeds; both packages start from the
same parameters (the JAX package's, handed over as numpy). Tolerances are
the reference's own: ``rtol=1e-4, atol=1e-5`` for the message op and its
gradients (``tests/test_kernels.py``), ``rtol=1e-5, atol=1e-5`` for the
segment sum, whose degree counts must be ``==``. The encoder sums the same
fp32 terms in other orders (einsum and matmul blockings), so it is held to
``rtol=1e-4, atol=1e-5`` too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rgcn_message import basis_message as j_basis_message
from repro.kernels.rgcn_message import segment_sum_onehot as j_segment_sum
from repro.models import rgcn as jrgcn
from repro_torch.convert import flatten_tree
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.rgcn_message import (
    basis_message, segment_plan, segment_sum,
)
from repro_torch.models import rgcn

MSG_TOL = dict(rtol=1e-4, atol=1e-5)
SEG_TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def pad_rows(x, n, fill=0):
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def message_inputs(rng, v, e, d_in, d_out, nb, r):
    mask = rng.random(e) < 0.8
    mask[: min(e, 5)] = False
    return dict(
        h=rng.normal(size=(v, d_in)).astype(np.float32),
        src=rng.integers(0, v, e).astype(np.int32),
        rel=rng.integers(0, r, e).astype(np.int32),
        dst=rng.integers(0, v, e).astype(np.int32),
        mask=mask,
        bases=(rng.normal(size=(nb, d_in, d_out)) * 0.2).astype(np.float32),
        coeffs=rng.normal(size=(r, nb)).astype(np.float32))


# ---------------------------------------------------------------------- #
# the two kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("e,d_in,d_out,nb,r", [
    (300, 75, 75, 2, 474),      # the paper's FB15k-237 widths, ragged E
    (128, 75, 75, 2, 474),
    (77, 24, 16, 3, 9),         # feature mode: d_in != d_out
    (5, 8, 8, 1, 2),            # all edges masked
])
def test_basis_message_plain_matches_pallas(e, d_in, d_out, nb, r):
    rng = np.random.default_rng(e + d_in)
    a = message_inputs(rng, 50, e, d_in, d_out, nb, r)
    h_t = a["h"][a["dst"]]
    coef = a["coeffs"][a["rel"]]
    e_pad = -(-e // 128) * 128
    want = np.asarray(j_basis_message(
        jnp.asarray(pad_rows(h_t, e_pad)), jnp.asarray(pad_rows(coef, e_pad)),
        jnp.asarray(a["bases"]), jnp.asarray(pad_rows(a["mask"], e_pad)),
        interpret=True))[:e]
    got = basis_message(t(h_t), t(coef), t(a["bases"]), t(a["mask"]))
    np.testing.assert_allclose(got.numpy(), want, **MSG_TOL)
    assert (got.numpy()[~a["mask"]] == 0).all()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.basis_message_ref(
            jnp.asarray(h_t), jnp.asarray(coef), jnp.asarray(a["bases"]),
            jnp.asarray(a["mask"]))), **MSG_TOL)


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("e,v,d", [(300, 200, 75), (256, 128, 16),
                                   (40, 300, 8)])
def test_segment_sum_plain_matches_pallas(order, e, v, d):
    rng = np.random.default_rng(e * v + d)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    # half the segments stay empty; skewed counts on the rest
    seg = (rng.zipf(1.5, e) % (v // 2)).astype(np.int32)
    if order == "sorted":
        seg = np.sort(seg)
    mask = rng.random(e) < 0.85
    e_pad, v_pad = -(-e // 128) * 128, -(-v // 128) * 128
    want_agg, want_deg = j_segment_sum(
        jnp.asarray(pad_rows(msg, e_pad)), jnp.asarray(pad_rows(seg, e_pad)),
        jnp.asarray(pad_rows(mask, e_pad)), v_pad, interpret=True)
    agg, deg = segment_sum(t(msg), t(seg), t(mask), v)
    np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg)[:v],
                               **SEG_TOL)
    np.testing.assert_array_equal(deg.numpy(),
                                  np.asarray(want_deg)[:v, 0])
    agg_r, deg_r = jref.segment_mean_ref(
        jnp.asarray(msg), jnp.asarray(seg), jnp.asarray(mask), v)
    np.testing.assert_allclose(agg.numpy(), np.asarray(agg_r), **SEG_TOL)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(deg_r))


def test_segment_plan_sorts_stably_and_chunks():
    seg = torch.tensor([3, 0, 3, 1, 3, 0, 2], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True, True, True])
    perm, offsets, chunk_ptr = segment_plan(seg, mask, 5)
    assert perm.tolist() == [1, 5, 3, 6, 0, 4, 2]   # masked edge 2 last
    assert offsets.tolist() == [0, 2, 3, 4, 6, 6]
    assert chunk_ptr.tolist() == [0, 1, 2, 3, 4, 4]  # segment 4 is empty
    many = torch.zeros(70, dtype=torch.int32)
    _, offsets, chunk_ptr = segment_plan(many, torch.ones(70, dtype=bool), 2)
    assert offsets.tolist() == [0, 70, 70] and chunk_ptr.tolist() == [0, 3, 3]


def test_kernel_wrappers_reject_other_devices():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        basis_message(x, torch.zeros((4, 1), device="meta"),
                      torch.zeros((1, 3, 3), device="meta"),
                      torch.zeros(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        _build.on_cpu("segment_sum", torch.zeros(2), x)


# ---------------------------------------------------------------------- #
# the fused message op, forward and gradients
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("v,e,d_in,d_out,nb,r", [
    (64, 200, 16, 16, 2, 5),
    (300, 1024, 75, 75, 2, 474),
    (33, 129, 8, 12, 1, 2),
])
def test_rgcn_message_basis_matches_reference(v, e, d_in, d_out, nb, r):
    rng = np.random.default_rng(v + e)
    a = message_inputs(rng, v, e, d_in, d_out, nb, r)
    j = {k: jnp.asarray(x) for k, x in a.items()}
    want = jax.jit(jops.rgcn_message_basis)(
        j["h"], j["src"], j["rel"], j["dst"], j["mask"], j["bases"],
        j["coeffs"])
    p = {k: t(x) for k, x in a.items()}
    got = ops.rgcn_message_basis(p["h"], p["src"], p["rel"], p["dst"],
                                 p["mask"], p["bases"], p["coeffs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MSG_TOL)
    np.testing.assert_allclose(
        ref.rgcn_message_ref(p["h"], p["src"], p["rel"], p["dst"], p["mask"],
                             p["bases"], p["coeffs"]).numpy(),
        np.asarray(want), **MSG_TOL)


def test_rgcn_message_basis_grads_match_reference():
    rng = np.random.default_rng(3)
    a = message_inputs(rng, 50, 150, 16, 16, 2, 4)
    j = {k: jnp.asarray(x) for k, x in a.items()}
    cot = rng.normal(size=(50, 16)).astype(np.float32)

    def f(h, bases, coeffs):
        return jnp.sum(jops.rgcn_message_basis(
            h, j["src"], j["rel"], j["dst"], j["mask"], bases, coeffs) * cot)

    want = jax.jit(jax.grad(f, (0, 1, 2)))(j["h"], j["bases"], j["coeffs"])
    leaves = [t(a[k]).requires_grad_() for k in ("h", "bases", "coeffs")]
    out = ops.rgcn_message_basis(leaves[0], t(a["src"]), t(a["rel"]),
                                 t(a["dst"]), t(a["mask"]), leaves[1],
                                 leaves[2])
    (out * t(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **MSG_TOL)


def edge_case_inputs(case):
    """Message inputs with duplicate tails and relations, masked edges and
    isolated vertices (deg = 0: in no edge at all), d_in != d_out."""
    rng = np.random.default_rng(11)
    v, e = 40, 300
    a = message_inputs(rng, v, e, 12, 10, 3, 5)
    if case == "duplicates":
        a["dst"][:120] = 7                     # one tail for 120 edges
        a["rel"][:200] = 2
        a["src"][40:140] = 3                   # a hub segment
    elif case == "masked":
        a["mask"][::2] = False
        a["mask"][200:] = False                # a masked tail of edges
    else:                                      # isolated
        a["src"] %= 30                         # vertices 30..39 in no edge
        a["dst"] %= 30
    return a


@pytest.mark.parametrize("case", ["duplicates", "masked", "isolated"])
def test_rgcn_message_basis_backward_matches_jax_grad(case):
    """The hand-written backward of the kernel op against jax.grad of
    repro.kernels.ops.rgcn_message_basis (Pallas in interpret mode forward,
    the reference's VJP backward), within MSG_TOL; isolated vertices get
    exactly zero state gradients."""
    a = edge_case_inputs(case)
    j = {k: jnp.asarray(x) for k, x in a.items()}
    cot = np.random.default_rng(12).normal(size=(40, 10)).astype(np.float32)

    def f(h, bases, coeffs):
        return jnp.sum(jops.rgcn_message_basis(
            h, j["src"], j["rel"], j["dst"], j["mask"], bases, coeffs) * cot)

    want = jax.jit(jax.grad(f, (0, 1, 2)))(j["h"], j["bases"], j["coeffs"])
    leaves = [t(a[k]).requires_grad_() for k in ("h", "bases", "coeffs")]
    out = ops.rgcn_message_basis(leaves[0], t(a["src"]), t(a["rel"]),
                                 t(a["dst"]), t(a["mask"]), leaves[1],
                                 leaves[2])
    (out * t(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **MSG_TOL)
    if case == "isolated":
        assert (leaves[0].grad[30:] == 0).all()


@pytest.mark.parametrize("case", ["duplicates", "masked", "isolated"])
def test_default_path_grads_match_jax_vjp(case):
    """The default (plain) encoder path, whose aggregation is now the
    differentiable segment sum (forward segment_sum, backward a gather),
    against the VJP of JAX's ref.rgcn_message_ref: output and gradients
    within MSG_TOL; the segment sum's own message gradient against the
    VJP of ref.segment_mean_ref within SEG_TOL."""
    a = edge_case_inputs(case)
    j = {k: jnp.asarray(x) for k, x in a.items()}
    rng = np.random.default_rng(13)
    cot = rng.normal(size=(40, 10)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda h, b, c: jref.rgcn_message_ref(
        h, j["src"], j["rel"], j["dst"], j["mask"], b, c),
        j["h"], j["bases"], j["coeffs"])
    want = vjp(jnp.asarray(cot))
    leaves = [t(a[k]).requires_grad_() for k in ("h", "bases", "coeffs")]
    out = rgcn.message_passing_ref(
        leaves[0], t(a["src"]), t(a["rel"]), t(a["dst"]), t(a["mask"]),
        {"bases": leaves[1], "coeffs": leaves[2]})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **MSG_TOL)
    (out * t(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **MSG_TOL)
    msg = rng.normal(size=(300, 10)).astype(np.float32)
    g_agg = rng.normal(size=(40, 10)).astype(np.float32)
    _, seg_vjp = jax.vjp(lambda m: jref.segment_mean_ref(
        m, j["src"], j["mask"], 40)[0], jnp.asarray(msg))
    m = t(msg).requires_grad_()
    agg, deg = ops.segment_sum_op(m, t(a["src"]), t(a["mask"]), 40)
    assert not deg.requires_grad
    agg.backward(t(g_agg))
    np.testing.assert_allclose(m.grad.numpy(),
                               np.asarray(seg_vjp(jnp.asarray(g_agg))[0]),
                               **SEG_TOL)
    assert (m.grad[~t(a["mask"])] == 0).all()


# ---------------------------------------------------------------------- #
# encoder and loss from the same parameters
# ---------------------------------------------------------------------- #
def configs(decomposition, use_kernel, feature_dim=None):
    kw = dict(num_entities=40, num_relations=6, hidden_dim=8, num_layers=2,
              num_bases=2, decomposition=decomposition, num_blocks=2,
              dropout=0.0, use_kernel=use_kernel, feature_dim=feature_dim)
    return jrgcn.RGCNConfig(**kw), rgcn.RGCNConfig(**kw)


def port_layers(jparams, cfg):
    layers = rgcn.rgcn_layers(cfg)
    flat = flatten_tree({"layers": jparams["layers"]})
    with torch.no_grad():
        for name, p in layers.named_parameters():
            p.copy_(t(flat[f"layers.{name}"]))
    return layers


@pytest.mark.parametrize("decomposition", ["basis", "block", "none"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rgcn_encode_matches_reference(decomposition, use_kernel):
    jcfg, cfg = configs(decomposition, use_kernel,
                        feature_dim=12 if decomposition == "basis" else None)
    jparams = jrgcn.init_rgcn_params(jax.random.PRNGKey(4), jcfg)
    layers = port_layers(jparams, cfg)
    assert dict(layers[0].named_parameters()).keys() == \
        jparams["layers"][0].keys()
    rng = np.random.default_rng(1)
    a = message_inputs(rng, 40, 160, jcfg.layer_in_dim(0), 8, 2, 6)
    x = a["h"]
    want = jax.jit(jrgcn.rgcn_encode, static_argnums=1)(
        jparams, jcfg, jnp.asarray(x), jnp.asarray(a["src"]),
        jnp.asarray(a["rel"]), jnp.asarray(a["dst"]), jnp.asarray(a["mask"]))
    got = rgcn.rgcn_encode({"layers": layers}, cfg, t(x), t(a["src"]),
                           t(a["rel"]), t(a["dst"]), t(a["mask"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MSG_TOL)
    for lp, jlp in zip(layers, jparams["layers"]):
        np.testing.assert_allclose(
            rgcn.relation_matrices(lp).detach().numpy(),
            np.asarray(jrgcn.relation_matrices(jlp, jcfg)), **MSG_TOL)


def test_dropout_keeps_expected_share_and_scales():
    _, cfg = configs("basis", False)
    cfg = rgcn.RGCNConfig(**{**cfg.__dict__, "dropout": 0.25})
    h = torch.ones((400, 8))
    lp = {"bases": torch.zeros((2, 8, 8)), "coeffs": torch.zeros((6, 2)),
          "self_weight": torch.eye(8)}
    e = torch.zeros(1, dtype=torch.int32)
    out = rgcn.rgcn_layer(h, e, e, e, torch.zeros(1, dtype=torch.bool), lp,
                          cfg, dropout_generator=torch.Generator()
                          .manual_seed(0))
    kept = out != 0
    assert 0.7 < float(kept.float().mean()) < 0.8
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 4 / 3))
