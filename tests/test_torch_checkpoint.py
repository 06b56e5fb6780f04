"""The PyTorch port's checkpoints (``repro_torch.training.checkpoint``,
``repro_torch.sharding.convert_table_layout``, ``KGETrainer.save_checkpoint``
/ ``restore``) against the JAX package's, on the CPU.

Each of the reference's checkpoint tests is ported (``tests/test_infra.py``
``TestCheckpoint``, ``tests/test_pipeline.py``
``TestShardedCheckpointRoundTrip``, the quantized round trips of
``tests/test_quantized_table.py`` and the exact resume of
``tests/test_system.py``), and held against ``repro`` where both sides can
run: the two packages read each other's checkpoints bit for bit, a port
trainer's checkpoint restores into the reference trainer's own tree and a
reference trainer's into the port's, and both write the same ``.npz`` keys.
Every gate is bitwise or ``==``, as the reference's are.
"""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_fb15k as j_synthetic_fb15k
from repro.models import KGEConfig as JKGEConfig
from repro.models import RGCNConfig as JRGCNConfig
from repro.models import init_kge_params as j_init_kge_params
from repro.sharding import embedding as jemb
from repro.training import KGETrainer as JKGETrainer
from repro.training import TrainConfig as JTrainConfig
from repro.training import checkpoint as jckpt
from repro_torch import convert
from repro_torch.data import synthetic_fb15k
from repro_torch.models.kge import KGEConfig, init_kge_params
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.sharding import (
    ShardedTableLayout, convert_table_layout, dequantize_rows,
    quantize_rows, quantize_table, shard_table, unshard_table,
)
from repro_torch.training import (
    KGETrainer, TrainConfig, latest_checkpoint, restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.checkpoint import (
    read_metadata, tree_leaves_with_path,
)

PACKAGES = {"port": (save_checkpoint, restore_checkpoint),
            "repro": (jckpt.save_checkpoint, jckpt.restore_checkpoint)}


def bits(x) -> bytes:
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)
    return x.dtype.str.encode() + str(x.shape).encode() + x.tobytes()


def leaves(tree):
    return {k: bits(v) for k, v in tree_leaves_with_path(tree)}


def npz_keys(path):
    with np.load(path) as z:
        return set(z.files)


class Pair(NamedTuple):
    first: object
    second: object


# ---------------------------------------------------------------------- #
# the format (tests/test_infra.py TestCheckpoint)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("saver,restorer", [
    ("port", "port"), ("port", "repro"), ("repro", "port")])
def test_roundtrip_across_packages(tmp_path, saver, restorer):
    """A tree of dicts, lists and a NamedTuple (with a ``None``) saved by
    one package restores bitwise in the other, its structure kept."""
    def tree(lib):
        arr = (lambda a: torch.from_numpy(np.asarray(a))) if lib == "port" \
            else jnp.asarray
        return {"a": arr(np.arange(6, dtype=np.int32).reshape(2, 3)),
                "b": [arr(np.linspace(-1, 1, 4, dtype=np.float32)),
                      {"c": arr(np.full((2, 2), 0.1, np.float32))}],
                "d": Pair(first=arr(np.int32(7)), second=None)}
    path = PACKAGES[saver][0](str(tmp_path), 7, tree(saver),
                              {"note": "x"})
    assert latest_checkpoint(str(tmp_path)) == path
    step, restored = PACKAGES[restorer][1](path, tree(restorer))
    assert step == 7
    assert leaves(restored) == leaves(tree(saver))
    assert isinstance(restored["d"], Pair) and restored["d"].second is None
    assert read_metadata(path) == jckpt.read_metadata(path) == (
        7, {"note": "x"})


def test_restore_gives_the_trees_dtype_and_kind(tmp_path):
    path = save_checkpoint(str(tmp_path), 0, {"a": np.arange(3.0)})
    _, t = restore_checkpoint(path, {"a": torch.zeros(3,
                                                      dtype=torch.float32)})
    assert t["a"].dtype == torch.float32 and t["a"].tolist() == [0, 1, 2]
    _, n = restore_checkpoint(path, {"a": np.zeros(3, np.float32)})
    assert isinstance(n["a"], np.ndarray) and n["a"].dtype == np.float32


def test_gc_keeps_last(tmp_path):
    for s in range(5):
        save_checkpoint(str(tmp_path), s, {"a": torch.zeros(2)}, keep=2)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_00000003.npz", "ckpt_00000004.npz"]


@pytest.mark.parametrize("keep", [0, -1])
def test_gc_keep_zero_or_less_keeps_everything(tmp_path, keep):
    for s in range(4):
        save_checkpoint(str(tmp_path), s, {"a": torch.zeros(2)}, keep=keep)
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".npz")]) == 4


def test_gc_removes_orphaned_manifests(tmp_path):
    tree = {"a": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 1, tree)
    path2 = save_checkpoint(str(tmp_path), 2, tree)
    os.remove(path2)                       # orphans ckpt_00000002.json
    save_checkpoint(str(tmp_path), 3, tree, keep=0)
    names = set(os.listdir(tmp_path))
    assert "ckpt_00000002.json" not in names
    assert {"ckpt_00000001.npz", "ckpt_00000001.json",
            "ckpt_00000003.npz", "ckpt_00000003.json"} <= names


@pytest.mark.parametrize("restorer", ["port", "repro"])
def test_shape_mismatch_raises(tmp_path, restorer):
    """The non-table strict shape check, in both packages, on a port
    checkpoint."""
    path = save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        PACKAGES[restorer][1](path, {"w": np.zeros((4, 4))})


def test_metadata_roundtrip_and_manifest(tmp_path):
    path = save_checkpoint(str(tmp_path), 5, {"b": torch.zeros(2),
                                              "a": torch.ones(1)},
                           metadata={"epoch": 5, "key": [1, 2]})
    assert read_metadata(path) == (5, {"epoch": 5, "key": [1, 2]})
    with open(path.replace(".npz", ".json")) as f:
        text = f.read()
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 5,
                                  {"b": jnp.zeros(2), "a": jnp.ones(1)},
                                  metadata={"epoch": 5, "key": [1, 2]})
    with open(jpath.replace(".npz", ".json")) as f:
        assert f.read() == text
    assert npz_keys(path) == npz_keys(jpath) == {"a", "b"}


def test_missing_leaf_raises(tmp_path):
    path = save_checkpoint(str(tmp_path), 0, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        restore_checkpoint(path, {"a": torch.zeros(2), "b": torch.zeros(1)})


# ---------------------------------------------------------------------- #
# table layouts (tests/test_pipeline.py TestShardedCheckpointRoundTrip)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_convert_table_layout_equals_reference(seed):
    """The port's conversion is ``==`` the reference's on random shapes,
    and raises where the reference raises."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        v, d = int(rng.integers(1, 40)), int(rng.integers(1, 5))
        src = rng.normal(size=(v, d)).astype(np.float32)
        s_a, s_b = (int(x) for x in rng.integers(0, 6, 2))
        a = src if s_a == 0 else jemb.shard_table(
            src, jemb.ShardedTableLayout(v, s_a))
        v_b = v if rng.random() < .7 else int(rng.integers(1, 40))
        shape_b = ((v_b, d) if s_b == 0 else
                   (s_b, -(-v_b // s_b), d))
        num_rows = None if rng.random() < .3 else (
            v if rng.random() < .8 else int(rng.integers(1, 40)))
        try:
            want = jemb.convert_table_layout(a, shape_b, num_rows=num_rows)
        except ValueError:
            with pytest.raises(ValueError):
                convert_table_layout(a, shape_b, num_rows=num_rows)
            continue
        got = convert_table_layout(a, shape_b, num_rows=num_rows)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="cannot convert"):
        convert_table_layout(np.zeros((4, 3)), (4, 2))


def kge_cfg(shards):
    return KGEConfig(RGCNConfig(num_entities=101, num_relations=6,
                                hidden_dim=16, num_layers=2, num_bases=2,
                                num_table_shards=shards))


def model_tree(shards, seed=0):
    model = init_kge_params(np.random.default_rng(seed), kge_cfg(shards),
                            "cpu")
    return convert.kge_tree((n, p.detach()) for n, p in
                            model.named_parameters())


def test_save_sharded_restore_dense_and_back(tmp_path):
    dense, sharded = model_tree(1), model_tree(4)
    assert sharded["entity_embedding"].shape[0] == 4
    path = save_checkpoint(str(tmp_path / "a"), 1, sharded)
    step, restored = restore_checkpoint(path, model_tree(1, seed=5))
    assert step == 1 and leaves(restored) == leaves(dense)
    path = save_checkpoint(str(tmp_path / "b"), 2, dense)
    _, restored = restore_checkpoint(path, model_tree(4, seed=5))
    assert leaves(restored) == leaves(sharded)
    path = save_checkpoint(str(tmp_path / "c"), 3, sharded)
    _, restored = restore_checkpoint(path, model_tree(2, seed=5),
                                     entity_rows=101)
    assert bits(unshard_table(restored["entity_embedding"], 101)) == \
        bits(dense["entity_embedding"])
    # the reference reads the port's sharded checkpoint into its own dense
    # tree, bit for bit
    jtree = j_init_kge_params(jax.random.PRNGKey(0), JKGEConfig(
        rgcn=JRGCNConfig(num_entities=101, num_relations=6, hidden_dim=16,
                         num_layers=2, num_bases=2)))
    _, restored = jckpt.restore_checkpoint(path, jtree, entity_rows=101)
    assert leaves(restored) == leaves(dense)


# ---------------------------------------------------------------------- #
# quantized tables (tests/test_quantized_table.py, checkpoint round trips)
# ---------------------------------------------------------------------- #
V, D = 37, 8


def _table(seed, rows, d, emin, emax, zero_row):
    """Random fp32 table with magnitudes over ``2^[emin, emax]`` (the
    reference test's: the subnormal and near-overflow scales)."""
    rng = np.random.default_rng(seed)
    lo, hi = sorted((emin, emax))
    x = (rng.choice([-1.0, 1.0], size=(rows, d))
         * rng.uniform(1.0, 2.0, size=(rows, d))
         * np.exp2(rng.uniform(lo, hi, size=(rows, d)))).astype(np.float32)
    if zero_row:
        x[0] = 0.0
    return x


def _quant_tree(emb, s, rows=V):
    stacked = shard_table(torch.from_numpy(emb), ShardedTableLayout(rows, s))
    return {"params": {"entity_embedding": quantize_table(stacked)},
            "w": torch.ones(3, 3)}


def _fp32_tree(emb, s):
    t = torch.from_numpy(emb)
    return {"params": {"entity_embedding": t if s == 0 else shard_table(
        t, ShardedTableLayout(V, s))}, "w": torch.ones(3, 3)}


def _j(tree):
    """The same tree with numpy leaves, for the reference."""
    return jax.tree_util.tree_map(lambda x: x.numpy(), tree)


@pytest.fixture()
def emb():
    return _table(7, V, D, -6, 6, zero_row=True)


def restore_both(path, like):
    """The port's restore and the reference's of one checkpoint into the
    same tree: bitwise equal. Returns the port's."""
    _, got = restore_checkpoint(path, like, entity_rows=V)
    _, want = jckpt.restore_checkpoint(path, _j(like), entity_rows=V)
    assert leaves(got) == leaves(want)
    return got


def test_ckpt_quant_reshard_exact(tmp_path, emb):
    path = save_checkpoint(str(tmp_path), 1, _quant_tree(emb, 2))
    t4 = restore_both(path, _quant_tree(emb, 4))
    assert leaves(t4) == leaves(_quant_tree(emb, 4))
    path4 = save_checkpoint(str(tmp_path / "b"), 2, t4)
    t2 = restore_both(path4, _quant_tree(emb, 2))
    assert leaves(t2) == leaves(_quant_tree(emb, 2))


def test_ckpt_quant_to_fp32_is_dequantize(tmp_path, emb):
    path = save_checkpoint(str(tmp_path), 1, _quant_tree(emb, 2))
    tree = restore_both(path, _fp32_tree(emb, 0))
    stacked = shard_table(torch.from_numpy(emb), ShardedTableLayout(V, 2))
    want = dequantize_rows(*quantize_rows(stacked)).reshape(-1, D)[:V]
    assert bits(tree["params"]["entity_embedding"]) == bits(want)


def test_ckpt_fp32_to_quant_requantizes_deterministically(tmp_path, emb):
    path = save_checkpoint(str(tmp_path), 1, _fp32_tree(emb, 0))
    a = restore_both(path, _quant_tree(emb, 2))
    _, b = restore_checkpoint(path, _quant_tree(emb, 2), entity_rows=V)
    assert leaves(a) == leaves(_quant_tree(emb, 2)) == leaves(b)


def test_ckpt_full_cycle_fp32_quant_reshard_fp32(tmp_path, emb):
    p1 = save_checkpoint(str(tmp_path / "1"), 1, _fp32_tree(emb, 0))
    q2 = restore_both(p1, _quant_tree(emb, 2))
    p2 = save_checkpoint(str(tmp_path / "2"), 2, q2)
    q4 = restore_both(p2, _quant_tree(emb, 4))
    p3 = save_checkpoint(str(tmp_path / "3"), 3, q4)
    f2 = restore_both(p3, _fp32_tree(emb, 2))
    stacked = shard_table(torch.from_numpy(emb), ShardedTableLayout(V, 2))
    assert bits(f2["params"]["entity_embedding"]) == bits(
        dequantize_rows(*quantize_rows(stacked)))


def test_ckpt_wrong_code_dtype_errors(tmp_path, emb):
    tree = _quant_tree(emb, 2)
    q = tree["params"]["entity_embedding"]
    q["codes"] = q["codes"].to(torch.int16)
    path = save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="not a quantized table"):
        restore_checkpoint(path, _fp32_tree(emb, 0), entity_rows=V)
    with pytest.raises(ValueError, match="not a quantized table"):
        restore_checkpoint(path, _quant_tree(emb, 4), entity_rows=V)


def test_ckpt_non_f32_source_refuses_requantize(tmp_path, emb):
    tree = _fp32_tree(emb, 0)
    tree["params"]["entity_embedding"] = \
        tree["params"]["entity_embedding"].double()
    path = save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="expected float32"):
        restore_checkpoint(path, _quant_tree(emb, 2), entity_rows=V)


def test_ckpt_vocab_mismatch_errors(tmp_path, emb):
    path = save_checkpoint(str(tmp_path), 1, _quant_tree(emb, 2))
    wrong = _table(8, V + 5, D, -4, 4, zero_row=False)
    with pytest.raises((ValueError, KeyError)):
        restore_checkpoint(path, _quant_tree(wrong, 2, rows=V + 5),
                           entity_rows=V + 5)


# ---------------------------------------------------------------------- #
# the trainer: exact resume (tests/test_system.py) and both packages
# ---------------------------------------------------------------------- #
CFGS = {
    "fullgraph": dict(),
    "minibatch_S4": dict(batch_size=128, num_table_shards=4),
    "minibatch_S4_int8": dict(batch_size=128, num_table_shards=4,
                              table_dtype="int8"),
}


def train_cfg(**extra):
    return TrainConfig(num_trainers=2, epochs=2, hidden_dim=16,
                       learning_rate=0.05, **extra)


def param_bits(tr):
    out = {}
    for name, p in tr.params.named_parameters():
        t = p.detach()
        if name == "entity_embedding" and t.dim() == 3:
            t = unshard_table(t, tr.train_kg.num_entities)
        out[name] = bits(t)
    return out


@pytest.fixture(scope="module")
def splits():
    return synthetic_fb15k(scale=0.01, seed=4)


@pytest.mark.parametrize("name", list(CFGS))
def test_resume_is_exact(tmp_path, splits, name):
    """Two epochs without a break against one epoch, a checkpoint, and a
    new trainer that restores it (scrambled epoch and seed first) and runs
    the second: the same per-step losses and parameters, bitwise; the
    4-shard table's checkpoint also restored into 1 shard."""
    extra = CFGS[name]
    a = KGETrainer(splits, train_cfg(**extra), device="cpu")
    hist = a.fit(2)
    b = KGETrainer(splits, train_cfg(**extra), device="cpu")
    b.fit(1)
    path = b.save_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_00000001.npz")
    for shards in sorted({extra.get("num_table_shards", 1), 1}):
        c = KGETrainer(splits, train_cfg(**{**extra,
                                            "num_table_shards": shards}),
                       device="cpu")
        c._epoch, c._seed = 0, 999
        assert c.restore(path) == 1
        assert c._seed == a._seed
        rec = c.train_epoch()
        assert rec["epoch"] == 2 and rec["losses"] == hist[1]["losses"]
        assert param_bits(c) == param_bits(a)
        assert int(c.opt_state.step) == int(a.opt_state.step)


def test_restore_refuses_a_key_it_cannot_continue(tmp_path, splits):
    tr = KGETrainer(splits, train_cfg(), device="cpu")
    path = tr.save_checkpoint(str(tmp_path))
    manifest = path.replace(".npz", ".json")
    with open(manifest) as f:
        data = json.load(f)
    data["metadata"]["key"] = [7, 1]
    with open(manifest, "w") as f:
        json.dump(data, f)
    with pytest.raises(ValueError, match=r"\[0, seed \+ 1\]"):
        tr.restore(path)


@pytest.fixture(scope="module")
def both_trained(tmp_path_factory, splits):
    """A port trainer and a reference trainer of one config (full-graph
    and a 2-shard mini-batch), each after one epoch, with a checkpoint."""
    out = {}
    jsplits = j_synthetic_fb15k(scale=0.01, seed=4)
    for name, extra in (("fullgraph", {}),
                        ("minibatch_S2", dict(batch_size=128,
                                              num_table_shards=2))):
        kw = dict(num_trainers=2, epochs=1, hidden_dim=16,
                  learning_rate=0.05, seed=3, **extra)
        tr = KGETrainer(splits, TrainConfig(**kw), device="cpu")
        tr.fit(1)
        jtr = JKGETrainer(jsplits, JTrainConfig(**kw))
        jtr.fit(1)
        d = tmp_path_factory.mktemp(name)
        out[name] = (kw, tr, jtr, tr.save_checkpoint(str(d / "port")),
                     jtr.save_checkpoint(str(d / "repro")))
    return out


@pytest.mark.parametrize("name", ["fullgraph", "minibatch_S2"])
def test_port_checkpoint_restores_in_the_reference(both_trained, name):
    """A port trainer's checkpoint restores through
    ``repro.training.checkpoint.restore_checkpoint`` into the reference
    trainer's own ``{"params", "opt"}`` tree, bitwise the port's values;
    its metadata is the reference trainer's: the epoch and the raw
    ``PRNGKey(seed + 1)``; both packages write the same keys."""
    _, tr, jtr, port_path, repro_path = both_trained[name]
    like = {"params": jtr.params, "opt": jtr.opt_state}
    _, got = jckpt.restore_checkpoint(
        port_path, like, entity_rows=jtr.train_kg.num_entities)
    assert leaves(got) == leaves(tr._checkpoint_tree())
    step, meta = jckpt.read_metadata(port_path)
    assert step == 1 and meta["epoch"] == 1
    assert meta["key"] == np.asarray(jax.random.PRNGKey(tr.cfg.seed + 1),
                                     dtype=np.uint32).tolist()
    assert meta == jckpt.read_metadata(repro_path)[1]
    assert npz_keys(port_path) == npz_keys(repro_path)
    assert "opt/mu/layers/0/bases" in npz_keys(port_path)


@pytest.mark.parametrize("name", ["fullgraph", "minibatch_S2"])
def test_reference_checkpoint_restores_in_the_port(both_trained, splits,
                                                   name):
    """A reference trainer's checkpoint restores into a new port trainer:
    parameters, ``step``, ``mu`` and ``nu`` bitwise the reference's, the
    epoch and the seed its."""
    kw, _, jtr, _, repro_path = both_trained[name]
    tr = KGETrainer(splits, TrainConfig(**{**kw, "num_table_shards": 1}),
                    device="cpu")
    assert tr.restore(repro_path) == 1
    assert tr._seed == kw["seed"] + 1
    n = tr.train_kg.num_entities

    def dense(tree):
        tree = dict(tree)
        if np.ndim(tree["entity_embedding"]) == 3:
            tree["entity_embedding"] = jemb.unshard_table(
                np.asarray(tree["entity_embedding"]), n)
        return tree
    opt = jtr.opt_state
    want = {"params": dense(jtr.params),
            "opt": opt._replace(mu=dense(opt.mu), nu=dense(opt.nu))}
    assert leaves(tr._checkpoint_tree()) == leaves(want)
