"""The port's mixture-of-experts layer (``repro_torch.nn.moe``) against the
JAX package's (``repro.nn.moe``), on the CPU.

Parameters are the reference's own ``moe_params`` of a ``PRNGKey``, handed
over bit for bit; inputs are drawn with numpy from a seed. Before any
output is compared, the experts each token selects must equal the
reference's, token for token: at a near-tie between the k-th and the
(k+1)-th probability, fp32 logits that differ in the last bits can pick
another expert, and the output then differs by O(1). A failure names the
gap.

Tolerances: outputs and the auxiliary loss within ``rtol=1e-4, atol=1e-5``
(the port's layer gate, and the reference's own gate for capacity against
dense dispatch, ``tests/test_perf_variants.py``); gradients within
``rtol=5e-3, atol=1e-4`` (the reference's gradient gate there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as JM
from repro_torch.nn import moe as M

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def tt(tree):
    """A JAX parameter tree as torch tensors, bit for bit."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def layer(d=16, e=8, ff=32, shared=0, dense=0, seed=0):
    """``(JAX params, port params)`` of one MoE layer."""
    jp = JM.moe_params(jax.random.PRNGKey(seed), d, num_experts=e,
                       d_ff_expert=ff, num_shared=shared,
                       dense_residual_ff=dense)
    return jp, tt(jp)


def tokens(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_same_experts(jp, x, top_k):
    """The port's router picks the reference's experts, token for token."""
    logits = np.asarray(jnp.asarray(x) @ jp["router"]).reshape(
        -1, jp["router"].shape[1])
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, want = jax.lax.top_k(probs, top_k)
    _, _, got = M._route(tt(jp), torch.from_numpy(x.reshape(-1, x.shape[-1])),
                         top_k)
    bad = np.nonzero((got.numpy() != np.asarray(want)).any(-1))[0]
    if bad.size:
        p = np.sort(np.asarray(probs)[bad], axis=-1)[:, ::-1]
        gap = p[:, top_k - 1] - p[:, top_k] if top_k < p.shape[1] else 0
        raise AssertionError(f"tokens {bad.tolist()} pick other experts; "
                             f"k-th minus (k+1)-th probability: {gap}")


BRANCHES = {"routed": {}, "shared": {"shared": 1}, "dense": {"dense": 24},
            "both": {"shared": 2, "dense": 24}}


@pytest.mark.parametrize("e,k", [(8, 2), (4, 4), (8, 1)])
def test_expert_indices_equal_the_reference(e, k):
    jp, _ = layer(e=e)
    assert_same_experts(jp, tokens((4, 16, 16), seed=e + k), k)


@pytest.mark.parametrize("branches", sorted(BRANCHES))
def test_dense_dispatch_allclose_jax(branches):
    jp, tp = layer(**BRANCHES[branches])
    x = tokens((2, 12, 16), seed=1)
    assert_same_experts(jp, x, 2)
    want, waux = JM.moe_apply(jp, jnp.asarray(x), top_k=2)
    got, aux = M.moe_apply(tp, torch.from_numpy(x), top_k=2)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(waux), **LAYER_TOL)


@pytest.mark.parametrize("branches", sorted(BRANCHES))
def test_capacity_dispatch_allclose_jax(branches):
    """The default factor 1.25 drops tokens here (T 24, k 2, E 8: 8 slots
    an expert); the port drops the same ones."""
    jp, tp = layer(**BRANCHES[branches])
    x = tokens((2, 12, 16), seed=2)
    assert_same_experts(jp, x, 2)
    assert reference_drops(jp, x, 2, 1.25).any()
    want, waux = JM.moe_apply_capacity(jp, jnp.asarray(x), top_k=2)
    got, aux = M.moe_apply_capacity(tp, torch.from_numpy(x), top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(waux), **LAYER_TOL)


def reference_drops(jp, x, top_k, factor):
    """The (token, choice) pairs the reference's capacity dispatch drops:
    a stable sort of the pairs by expert, each expert keeping its first
    ``cap``."""
    e = jp["router"].shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1]))
                           @ jp["router"], axis=-1)
    flat = np.asarray(jax.lax.top_k(probs, top_k)[1]).reshape(-1)
    cap = M.capacity(flat.size // top_k, top_k, e, factor)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(flat.size)
    first = np.searchsorted(flat[order], np.arange(e))
    return (rank - first[flat] >= cap).reshape(-1, top_k)


def test_tight_capacity_drops_the_references_tokens():
    """Capacity factor 1.0 (T 64, k 2, E 8: 16 slots an expert): tokens are
    dropped, and the port's output is the reference's."""
    jp, tp = layer(shared=1, seed=3)
    x = tokens((2, 32, 16), seed=3)
    assert_same_experts(jp, x, 2)
    drops = reference_drops(jp, x, 2, 1.0)
    assert 0 < drops.sum() < drops.size
    want, waux = JM.moe_apply_capacity(jp, jnp.asarray(x), top_k=2,
                                       capacity_factor=1.0)
    got, aux = M.moe_apply_capacity(tp, torch.from_numpy(x), top_k=2,
                                    capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(waux), **LAYER_TOL)
    # a dropped pair is missing from its token's output: dense dispatch
    # differs exactly at the tokens with a drop
    dense, _ = M.moe_apply(tp, torch.from_numpy(x), top_k=2)
    moved = (got - dense).abs().amax(-1).reshape(-1).numpy() > 1e-5
    np.testing.assert_array_equal(moved, drops.any(-1))


@pytest.mark.parametrize("branches", ["routed", "both"])
def test_ample_capacity_equals_dense_dispatch(branches):
    """The reference's own gate (``tests/test_perf_variants.py``): with
    capacity for every pair, capacity dispatch == dense dispatch."""
    _, tp = layer(**BRANCHES[branches])
    x = torch.from_numpy(tokens((2, 8, 16), seed=4))
    dense, _ = M.moe_apply(tp, x, top_k=2)
    cap, _ = M.moe_apply_capacity(tp, x, top_k=2, capacity_factor=8.0)
    np.testing.assert_allclose(cap.numpy(), dense.numpy(), **LAYER_TOL)


def test_capacity_is_the_references_formula():
    # ceil(T k f / E), at least 8, rounded up to 8
    assert M.capacity(24, 2, 8, 1.25) == 8
    assert M.capacity(64, 2, 8, 1.0) == 16
    assert M.capacity(100, 6, 64, 1.25) == 16
    assert M.capacity(2048, 6, 64, 1.25) == 240
    assert M.capacity(3, 1, 4, 8.0) == 8


def test_decode_allclose_jax():
    jp, tp = layer(shared=1, dense=24)
    x = tokens((3, 1, 16), seed=5)
    want = JM.moe_apply_decode(jp, jnp.asarray(x), top_k=2)
    got = M.moe_apply_decode(tp, torch.from_numpy(x), top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def grads_of(fn, tp, x):
    live = {k: (v.detach().requires_grad_() if torch.is_tensor(v) else
                {kk: vv.detach().requires_grad_() for kk, vv in v.items()})
            for k, v in tp.items()}
    out, aux = fn(live, x)
    # a loss that reads every output and the aux, as loss_fn does
    w = torch.from_numpy(tokens(tuple(out.shape), seed=9))
    (torch.sum(out * w) + 0.5 * aux).backward()
    return {k: (v.grad if torch.is_tensor(v) else
                {kk: vv.grad for kk, vv in v.items()})
            for k, v in live.items()}


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_every_gradient_allclose_jax_the_routers_included(dispatch):
    """Every leaf's gradient, the router's too: it flows through the
    gathered top-k values (and the aux's mean probabilities), the same way
    on the CPU and the card."""
    jp, tp = layer(shared=1, dense=24, seed=6)
    x = tokens((2, 12, 16), seed=6)
    assert_same_experts(jp, x, 2)
    jfn = {"dense": JM.moe_apply, "capacity": JM.moe_apply_capacity}[dispatch]
    tfn = {"dense": M.moe_apply, "capacity": M.moe_apply_capacity}[dispatch]
    w = tokens(x.shape, seed=9)

    def jloss(p):
        out, aux = jfn(p, jnp.asarray(x), top_k=2)
        return jnp.sum(out * w) + 0.5 * aux
    want = jax.grad(jloss)(jp)
    got = grads_of(lambda p, xx: tfn(p, xx, top_k=2), tp,
                   torch.from_numpy(x))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == sum(len(v) if isinstance(v, dict) else 1
                              for v in got.values())
    for path, g in flat_w:
        keys = [str(p.key) for p in path]
        mine = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        np.testing.assert_allclose(mine.numpy(), np.asarray(g),
                                   err_msg=".".join(keys), **GRAD_TOL)
    assert float(got["router"].abs().max()) > 0


def test_topk_sparsity_equivalence():
    """The reference's own check, on the port: dense dispatch == an
    explicit loop over each token's selected experts."""
    d, e, k = 16, 4, 2
    _, tp = layer(d=d, e=e)
    x = torch.from_numpy(tokens((2, 3, d), seed=5))
    out, _ = M.moe_apply(tp, x, top_k=k)
    probs = torch.softmax(x @ tp["router"], -1)
    tv, ti = torch.topk(probs, k)
    tv = tv / tv.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for bi in range(2):
        for si in range(3):
            for kk in range(k):
                ei = int(ti[bi, si, kk])
                h = x[bi, si] @ tp["w_in"][ei]
                g = torch.nn.functional.silu(x[bi, si] @ tp["w_gate"][ei])
                want[bi, si] += tv[bi, si, kk] * ((g * h) @ tp["w_out"][ei])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **LAYER_TOL)


def test_aux_loss_range():
    """The reference's own check, on the port: the load-balance aux is at
    least 1 (perfectly balanced == 1 for top-1)."""
    _, tp = layer(e=4)
    _, aux = M.moe_apply(tp, torch.from_numpy(tokens((4, 8, 16), seed=6)),
                         top_k=1)
    assert float(aux) >= 0.99


def test_router_is_fp32_in_a_bf16_layer_and_routes_as_the_reference():
    """A bf16 layer keeps its router fp32 (``repro/nn/moe.py`` draws it so
    whatever the dtype) and its logits fp32; the rest is bf16. On the
    reference's weights so rounded, the port's bf16 output is within the
    reference's own bf16 error ``e`` (its largest |bf16 - fp32| output) of
    the reference's bf16 output, or one bf16 spacing where that is
    larger."""
    p = M.moe_params(torch.Generator().manual_seed(0), 16, num_experts=8,
                     d_ff_expert=32, num_shared=1, dense_residual_ff=24,
                     dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for k, t in p.items()
               if k not in ("router", "shared", "dense"))
    assert p["shared"]["w_in"].dtype == p["dense"]["w_out"].dtype \
        == torch.bfloat16
    jp, tp = layer(shared=1, dense=24, seed=7)
    jb = {k: (v if k == "router" else jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), v)) for k, v in jp.items()}
    tb = {k: (v if k == "router" else
              {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(torch.bfloat16))
          for k, v in tp.items()}
    xb = torch.from_numpy(tokens((2, 8, 16), seed=7)).to(torch.bfloat16)
    x32 = xb.float().numpy()
    want, _ = JM.moe_apply(jb, jnp.asarray(x32, jnp.bfloat16), top_k=2)
    want32, _ = JM.moe_apply(jp, jnp.asarray(x32), top_k=2)
    got, _ = M.moe_apply(tb, xb, top_k=2)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    e = float(np.abs(want - np.asarray(want32)).max())
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    err = np.abs(got.float().numpy() - want)
    assert (err <= np.maximum(e, spacing)).all(), (err.max(), e)


def test_expert_stacks_are_drawn_one_expert_at_a_time():
    """``_expert_init``'s scale and shape, stacked ``lead`` deep; on the
    meta device nothing is drawn."""
    gen = torch.Generator().manual_seed(0)
    w = M._expert_init(gen, 6, 64, 32, lead=(2,))
    assert w.shape == (2, 6, 64, 32)
    assert abs(float(w.std()) / (2 / 96) ** 0.5 - 1) < 0.05
    assert not torch.equal(w[:, 0], w[:, 1])
    meta = M._expert_init(None, 128, 7168, 4864, lead=(35,), device="meta")
    assert meta.device.type == "meta" and meta.shape == (35, 128, 7168, 4864)
