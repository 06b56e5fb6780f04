"""The PyTorch port's KGE model side against the JAX package's, on the CPU:
the full-graph loss and its gradients (with the JAX package's negative
draws handed to the port), the partition encoder, the decoders' training
forms and the optimizers.

Both packages start from the same parameters (the JAX package's, handed
over through ``repro_torch.convert``); inputs are drawn with numpy from
fixed seeds. The loss and gradients sum the same fp32 terms in other
orders than XLA, so they are held to ``rtol=1e-4, atol=1e-5`` (gradients
``atol=1e-6``: they are O(1e-4)); the BCE and optimizer formulas are
elementwise and are held to ``rtol=1e-6`` (``atol=1e-7``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.negative import constraint_based_negatives as j_negatives
from repro.models import decoders as jdec
from repro.models import kge as jkge
from repro.models import rgcn as jrgcn
from repro.training import optimizer as jopt
from repro_torch.convert import flatten_tree, kge_model_from_jax
from repro_torch.models import decoders, kge, rgcn
from repro_torch.training import optimizer as opt

MSG_TOL = dict(rtol=1e-4, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def padded_fb15k(seed):
    """The synthetic FB15k stand-in's training graph, in two padded
    partitions."""
    from repro.core import expand_all, pad_partitions, partition_graph
    from repro.data import synthetic_fb15k
    kg = synthetic_fb15k(scale=0.01, seed=seed)["train"] \
        .with_inverse_relations()
    return kg, pad_partitions(expand_all(kg, partition_graph(kg, 2), 2))


def kge_setup(use_kernel, decoder="distmult", seed=0):
    """A two-partition padded batch and both packages' configs and
    parameters."""
    kg, padded = padded_fb15k(seed)
    rkw = dict(num_entities=kg.num_entities,
               num_relations=kg.num_relations, hidden_dim=12,
               dropout=0.0, use_kernel=use_kernel)
    jcfg = jkge.KGEConfig(jrgcn.RGCNConfig(**rkw), decoder=decoder)
    cfg = kge.KGEConfig(rgcn.RGCNConfig(**rkw), decoder=decoder)
    jparams = jkge.init_kge_params(jax.random.PRNGKey(seed), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    model = kge_model_from_jax(host, cfg, device="cpu")
    return padded, jcfg, cfg, jparams, model


def part_slice(padded, i):
    return {f.name: getattr(padded, f.name)[i]
            for f in dataclasses.fields(padded)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("decoder", ["distmult", "transe"])
def test_fullgraph_loss_and_grads_match_reference(use_kernel, decoder):
    padded, jcfg, cfg, jparams, model = kge_setup(use_kernel, decoder)
    part = part_slice(padded, 1)
    jpart = {k: jnp.asarray(v) for k, v in part.items()}
    rng = jax.random.PRNGKey(11)
    k_neg, _ = jax.random.split(rng)
    pos = jnp.stack([jpart["src"], jpart["rel"], jpart["dst"]], axis=1)
    jneg, _ = j_negatives(k_neg, pos, 1, jpart["num_core_vertices"])

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jkge.fullgraph_loss(p, jcfg, b, rng),
        has_aux=True))(jparams, jpart)
    tpart = {k: t(v) for k, v in part.items()}
    loss, aux = kge.fullgraph_scored_loss(model, cfg, tpart,
                                          t(np.asarray(jneg)), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **MSG_TOL)
    assert float(aux["loss"]) == float(loss)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_encode_partition_matches_reference():
    padded, jcfg, cfg, jparams, model = kge_setup(True)
    part = part_slice(padded, 0)
    want = jax.jit(jkge.encode_partition, static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in part.items()})
    with torch.no_grad():
        got = kge.encode_partition(model, cfg,
                                   {k: t(v) for k, v in part.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MSG_TOL)


def test_fullgraph_loss_draws_negatives_then_dropout():
    padded, _, cfg, _, model = kge_setup(False)
    cfg = kge.KGEConfig(rgcn.RGCNConfig(**{**cfg.rgcn.__dict__,
                                           "dropout": 0.2}))
    part = {k: t(v) for k, v in part_slice(padded, 0).items()}
    l1, _ = kge.fullgraph_loss(model, cfg, part,
                               torch.Generator().manual_seed(3))
    l2, _ = kge.fullgraph_loss(model, cfg, part,
                               torch.Generator().manual_seed(3))
    l3, _ = kge.fullgraph_loss(model, cfg, part,
                               torch.Generator().manual_seed(4))
    assert float(l1) == float(l2) and float(l1) != float(l3)
    neg = kge.fullgraph_negatives(cfg, part, torch.Generator().manual_seed(3))
    drawn = torch.where(neg[:, 0] != part["src"], neg[:, 0], neg[:, 2])
    assert int(drawn.max()) < int(part["num_core_vertices"])


# ---------------------------------------------------------------------- #
# decoders' training forms
# ---------------------------------------------------------------------- #
def test_bce_loss_and_score_triplets_match_reference():
    rng = np.random.default_rng(2)
    scores = (rng.normal(size=300) * 20).astype(np.float32)
    labels = (rng.random(300) < .5).astype(np.float32)
    mask = (rng.random(300) < .7).astype(np.float32)
    np.testing.assert_allclose(
        float(decoders.bce_loss(t(scores), t(labels), t(mask))),
        float(jdec.bce_loss(jnp.asarray(scores), jnp.asarray(labels),
                            jnp.asarray(mask))), rtol=1e-6)
    assert float(decoders.bce_loss(t(scores), t(labels),
                                   torch.zeros(300))) == 0.0
    h = rng.normal(size=(30, 8)).astype(np.float32)
    trip = np.stack([rng.integers(0, 30, 50), rng.integers(0, 4, 50),
                     rng.integers(0, 30, 50)], 1).astype(np.int32)
    for name in ("distmult", "transe", "complex", "rotate"):
        params = jdec.init_decoder_params(jax.random.PRNGKey(1), name, 4, 8)
        want = jdec.score_triplets(params, name, jnp.asarray(h),
                                   jnp.asarray(trip))
        got = decoders.score_triplets(
            {k: t(np.asarray(v)) for k, v in params.items()}, name, t(h),
            t(trip))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------- #
# optimizers
# ---------------------------------------------------------------------- #
def _tree(rng):
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


@pytest.mark.parametrize("make", [
    lambda m: m.adam(0.01),
    lambda m: m.adam(0.05, weight_decay=0.01, grad_clip_norm=0.5),
    lambda m: m.adam(m.warmup_cosine_schedule(0.1, 2, 5)),
    lambda m: m.sgd(0.1, momentum=0.9),
    lambda m: m.sgd(m.constant_schedule(0.2)),
])
def test_optimizer_three_steps_match_reference(make):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jo, po = make(jopt), make(opt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: t(v) for k, v in params.items()}
    js, ts = jo.init(jp), po.init(tp)
    for _ in range(3):
        grads = _tree(rng)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = po.update({k: t(v) for k, v in grads.items()}, ts, tp)
        tp = opt.apply_updates(tp, tu)
    assert int(ts.step) == int(js.step) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(opt.global_norm(tp)),
        float(jopt.global_norm(jp)), rtol=1e-6)
