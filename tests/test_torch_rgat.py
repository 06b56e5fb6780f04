"""The port's RGAT encoder against the JAX package's, on the CPU: the three
tests of ``tests/test_extensions.py`` (shapes and finiteness, the segment
softmax's normalisation, masked edges leaving the self-loop path alone),
then ``rgat_encode`` and every gradient leaf against ``jax.grad`` of the
reference's from the same weights, and the plans path against the path
without plans.

Inputs come from numpy seeds and the port's own partition pipeline; both
packages start from the reference's weights (``convert.rgat_params_from_jax``).
Tolerance: the reference's own, ``rtol=1e-4, atol=1e-5``
(``tests/test_extensions.py``). The port sums the same fp32 terms in other
orders (``index_add_`` and matmul blockings against XLA's scatters), and
takes the segment max detached, whose gradient cancels in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rgat as jrgat
from repro.models.rgcn import RGCNConfig as JRGCNConfig
from repro_torch.convert import (
    flatten_tree, rgat_params_from_jax, rgat_params_to_jax,
)
from repro_torch.core.expansion import expand_all, pad_partitions
from repro_torch.core.graph import make_synthetic_kg
from repro_torch.core.partition import partition_graph
from repro_torch.kernels.ops import EdgePlans
from repro_torch.models import RGATConfig, init_rgat_params, rgat_encode
from repro_torch.models.rgat import _segment_softmax
from repro_torch.models.rgcn import RGCNConfig

TOL = dict(rtol=1e-4, atol=1e-5)
D = 16


@pytest.fixture(scope="module")
def setup():
    kg = make_synthetic_kg(150, 5, 900, seed=5).with_inverse_relations()
    pb = pad_partitions(
        expand_all(kg, partition_graph(kg, 2, "vertex_cut"), 2))
    base = dict(num_entities=kg.num_entities,
                num_relations=kg.num_relations, hidden_dim=D, num_layers=2)
    jcfg = jrgat.RGATConfig(base=JRGCNConfig(**base))
    cfg = RGATConfig(base=RGCNConfig(**base))
    jparams = jrgat.init_rgat_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = rgat_params_from_jax(tree, cfg, device="cpu")
    return cfg, jcfg, params, jparams, pb


def edges(pb, i=0):
    return tuple(torch.from_numpy(np.asarray(a[i])) for a in
                 (pb.src, pb.rel, pb.dst, pb.edge_mask))


def test_forward_shapes_finite(setup):
    cfg, _, params, _, pb = setup
    x = params["entity_embedding"][torch.from_numpy(pb.local_to_global[0])]
    h = rgat_encode(params, cfg, x, *edges(pb))
    assert h.shape == (pb.padded_vertices, D)
    assert bool(torch.isfinite(h).all())


def test_attention_normalizes():
    """The softmax over a head's unmasked edges sums to 1; masked edges
    get 0."""
    logits = torch.tensor([0.5, 1.0, -2.0, 3.0])
    seg = torch.tensor([0, 0, 1, 1])
    mask = torch.tensor([True, True, True, False])
    a = _segment_softmax(logits, seg, mask, 3)
    assert float(a[0] + a[1]) == pytest.approx(1.0, rel=1e-5)
    assert float(a[2]) == pytest.approx(1.0, rel=1e-5)
    assert float(a[3]) == 0.0
    want = jrgat._segment_softmax(jnp.asarray(logits.numpy()),
                                  jnp.asarray(seg.numpy()),
                                  jnp.asarray(mask.numpy()), 3)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), **TOL)


def test_mask_blocks_influence(setup):
    """With every edge masked the output is the self-loop path alone."""
    cfg, _, params, _, pb = setup
    x = params["entity_embedding"][torch.from_numpy(pb.local_to_global[0])]
    src, rel, dst, mask = edges(pb)
    h = rgat_encode(params, cfg, x, src, rel, dst, torch.zeros_like(mask))
    want = torch.relu(x @ params["layers"][0]["self_weight"]) \
        @ params["layers"][1]["self_weight"]
    np.testing.assert_allclose(h.numpy(), want.numpy(), **TOL)


def test_converter_round_trips_bitwise(setup):
    cfg, _, params, jparams, _ = setup
    back = flatten_tree(rgat_params_to_jax(params))
    for name, a in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                       jparams)).items():
        assert back[name].tobytes() == a.tobytes(), name


@pytest.mark.parametrize("part", [0, 1])
def test_encode_and_gradients_against_jax_grad(setup, part):
    """``rgat_encode`` and the gradient of a fixed random projection of its
    output, for every parameter leaf and the vertex input, against the
    reference's (the encode and ``jax.grad``) from the same weights."""
    cfg, jcfg, params, jparams, pb = setup
    ids = np.asarray(pb.local_to_global[part])
    x = np.asarray(jparams["entity_embedding"])[ids]
    proj = np.random.default_rng(part).normal(
        size=(pb.padded_vertices, D)).astype(np.float32)
    jargs = [jnp.asarray(np.asarray(a[part])) for a in
             (pb.src, pb.rel, pb.dst, pb.edge_mask)]

    def jloss(p, xin):
        h = jrgat.rgat_encode(p, jcfg, xin, *jargs)
        return jnp.sum(h * proj), h
    layers_only = {"layers": jparams["layers"]}
    (_, jh), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        layers_only, jnp.asarray(x))

    live = {"layers": [{k: v.detach().clone().requires_grad_()
                        for k, v in lp.items()} for lp in params["layers"]]}
    xt = torch.from_numpy(x).requires_grad_()
    h = rgat_encode(live, cfg, xt, *edges(pb, part))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    (h * torch.from_numpy(proj)).sum().backward()
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jg))
    for i, lp in enumerate(live["layers"]):
        for k, v in lp.items():
            np.testing.assert_allclose(v.grad.numpy(),
                                       want[f"layers.{i}.{k}"], **TOL,
                                       err_msg=f"layers.{i}.{k}")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)


def test_plans_path_equals_the_path_without(setup):
    """Given ``EdgePlans`` (shared by the layers) the encode and its
    gradients are the same bits as without them."""
    cfg, _, params, _, pb = setup
    x = params["entity_embedding"][torch.from_numpy(pb.local_to_global[1])]
    src, rel, dst, mask = edges(pb, 1)

    def run(plans):
        live = {"layers": [{k: v.detach().clone().requires_grad_()
                            for k, v in lp.items()}
                           for lp in params["layers"]]}
        h = rgat_encode(live, cfg, x, src, rel, dst, mask, plans=plans)
        h.square().sum().backward()
        return [h.detach()] + [v.grad for lp in live["layers"]
                               for v in lp.values()]
    plans = EdgePlans(src, rel, dst, mask, x.shape[0], cfg.base.num_relations)
    for a, b in zip(run(plans), run(None)):
        assert torch.equal(a, b)
