"""The port's LM sharding rules, abstract inputs and activation pins
against the JAX package's, on the CPU, with no devices: the reference's
rules run against ``jax.sharding.AbstractMesh`` at the production meshes
(16 x 16 and 2 x 16 x 16), the port's against the same axis sizes.

Every parameter leaf of every configuration at full size, in the 2-D and
1-D modes, every batch leaf of every input shape and every cache leaf of
both decode shapes: the port's spec ``==`` the reference's
``PartitionSpec`` and its shard shape ``==`` ``NamedSharding.shard_shape``.
Then the reference's three rule cases (``tests/test_infra.py``), the
abstract batches, caches, trip counts and long-context rule ``==`` the
reference's, and the pins: the input unchanged without a mesh, the
reference's placement on a fake 2 x 2 mesh.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS
from repro.launch import specs as JS
from repro.sharding import context as jctx
from repro.sharding import rules as JR
from repro_torch.configs import ARCHS
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (
    PRODUCTION_MESHES, fake_process_group, make_fake_mesh,
)
from repro_torch.nn.transformer import leaves
from repro_torch.sharding import context as ctx
from repro_torch.sharding import rules as R

MESHES = {kind: (AbstractMesh(shape, names), dict(zip(names, shape)))
          for kind, (shape, names) in PRODUCTION_MESHES.items()}
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def j_leaves(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield ".".join(JR._path_names(path)), leaf


def same_spec(spec, jspec, shape, jmesh, axes, what):
    assert spec == jspec, (what, spec, jspec)
    assert R.shard_shape(spec, shape, axes) == \
        NamedSharding(jmesh, jspec).shard_shape(shape), what


def test_production_meshes_are_the_reference():
    assert PRODUCTION_MESHES == {"single": ((16, 16), ("data", "model")),
                                 "multi": ((2, 16, 16),
                                           ("pod", "data", "model"))}


@pytest.mark.parametrize("mode", ["2d", "1d"])
@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, kind, mode):
    jmesh, axes = MESHES[kind]
    jparams = dict(j_leaves(JS.abstract_params(J_ARCHS[arch])))
    params = dict(leaves(S.abstract_params(ARCHS[arch])))
    assert sorted(params) == sorted(jparams)
    specs = R.param_shardings(S.abstract_params(ARCHS[arch]), axes, mode)
    for name, t in params.items():
        shape = tuple(t.shape)
        assert shape == tuple(jparams[name].shape), name
        assert DTYPES[jnp.dtype(jparams[name].dtype)] == t.dtype, name
        jspec = JR.spec_for_param(tuple(name.split(".")), shape, jmesh, mode)
        same_spec(specs[name], jspec, shape, jmesh, axes, name)


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_equal_the_reference(arch, kind):
    jmesh, axes = MESHES[kind]
    for sname, shape in S.INPUT_SHAPES.items():
        jshape = JS.INPUT_SHAPES[sname]
        batch = S.abstract_batch(ARCHS[arch], shape)
        jbatch = JS.abstract_batch(J_ARCHS[arch], jshape)
        assert sorted(batch) == sorted(jbatch)
        for k, t in batch.items():
            dims = tuple(t.shape)
            assert dims == tuple(jbatch[k].shape), (sname, k)
            assert DTYPES[jnp.dtype(jbatch[k].dtype)] == t.dtype, (sname, k)
            same_spec(R.spec_for_batch_leaf(dims, axes),
                      JR.spec_for_batch_leaf(dims, jmesh), dims, jmesh, axes,
                      (sname, k))
        if shape.mode != "decode":
            continue
        cache = dict(leaves(S.abstract_cache(ARCHS[arch], shape)))
        jcache = dict(j_leaves(JS.abstract_cache(J_ARCHS[arch], jshape)))
        assert sorted(cache) == sorted(jcache), sname
        for name, t in cache.items():
            dims = tuple(t.shape)
            assert dims == tuple(jcache[name].shape), (sname, name)
            assert DTYPES[jnp.dtype(jcache[name].dtype)] == t.dtype, name
            path = tuple(name.split("."))
            same_spec(R.spec_for_cache_leaf(path, dims, axes),
                      JR.spec_for_cache_leaf(path, dims, jmesh), dims, jmesh,
                      axes, (sname, name))


def test_the_reference_rule_cases():
    """``tests/test_infra.py::TestShardingRules`` on the port."""
    axes = {"data": 1, "model": 1}
    assert R.spec_for_param(("layers", "attn", "w_q"), (64, 128), axes) \
        == P("data", "model")
    assert R.spec_for_param(("foo",), (64,), axes) == P()
    assert R.spec_for_param(("w_q",), (7,), axes) == P()
    assert R.spec_for_param(("groups", "0", "moe", "w_in"), (4, 16, 32),
                            axes) == P("model", "data", None)


def test_indivisible_dims_replicate():
    """The reference's divisibility guard: glm4-9b's stacked ``w_k`` (2 KV
    heads x 128 = 256 columns) is split over the 16-wide model axis, a
    width of 200 is replicated on it."""
    jmesh, axes = MESHES["single"]
    shape = (40, 4096, 256)        # stacked w_k: 2 heads x 128 on 16
    spec = R.spec_for_param(("groups", "0", "attn", "w_k"), shape, axes)
    assert spec == (None, "data", "model")
    assert R.spec_for_param(("groups", "0", "attn", "w_k"), (40, 4096, 200),
                            axes) == (None, "data", None)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_trip_counts_and_long_context_rule(arch):
    assert S.scan_trip_count(ARCHS[arch]) == \
        JS.scan_trip_count(J_ARCHS[arch])
    assert S.LONG_CONTEXT_OK == JS.LONG_CONTEXT_OK
    for sname in S.INPUT_SHAPES:
        cfg, note = S.resolve_arch_for_shape(arch, sname)
        jcfg, jnote = JS.resolve_arch_for_shape(arch, sname)
        assert note == jnote
        assert (cfg is None) == (jcfg is None)
        if cfg is not None:
            assert cfg.name == jcfg.name


def test_input_shapes_equal_the_reference():
    assert {k: (v.seq_len, v.global_batch, v.mode)
            for k, v in S.INPUT_SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.mode)
         for k, v in JS.INPUT_SHAPES.items()}


def test_opt_state_specs_follow_the_parameters():
    params = S.abstract_params(ARCHS["gemma-2b"].reduced())
    axes = {"data": 2, "model": 2}
    p_sh = R.param_shardings(params, axes)
    o_sh = R.opt_state_shardings(S.abstract_opt_state(params), p_sh, axes)
    assert o_sh.step == () and o_sh.mu == p_sh and o_sh.nu == p_sh


# ---------------------------------------------------------------------- #
# the activation pins
# ---------------------------------------------------------------------- #
PINS = [("act", (4, 8, 32), False), ("act", (4, 8, 32), True),
        ("act", (3, 8, 32), False), ("logits", (4, 8, 64), None),
        ("logits", (4, 63), None)]


def test_pins_return_their_input_without_a_mesh():
    x = torch.randn(4, 8, 32)
    assert ctx.shard_activation(x) is x
    assert ctx.shard_activation(x, seq_over_model=True) is x
    assert ctx.shard_logits(x) is x


def reference_spec(monkeypatch, jmesh, what, shape, seq):
    """The spec the reference's pin gives ``shape`` (its constraint
    captured, not applied)."""
    monkeypatch.setattr(jctx, "_constraint", lambda x, spec: spec)
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    with jctx.mesh_context(jmesh):
        if what == "act":
            return jctx.shard_activation(x, seq_over_model=seq)
        return jctx.shard_logits(x)


def test_pins_place_as_the_reference_on_a_fake_mesh(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    with fake_process_group(4):
        mesh = make_fake_mesh((2, 2), ("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True):
            for what, shape, seq in PINS:
                jspec = reference_spec(monkeypatch, jmesh, what, shape, seq)
                x = DTensor.from_local(torch.empty(shape), mesh,
                                       [Replicate(), Replicate()],
                                       run_check=False)
                with ctx.mesh_context(mesh):
                    y = (ctx.shard_activation(x, seq_over_model=seq)
                         if what == "act" else ctx.shard_logits(x))
                assert tuple(y.placements) == tuple(
                    R.placements(tuple(jspec), mesh)), (what, shape, seq)
                assert tuple(y.shape) == shape
