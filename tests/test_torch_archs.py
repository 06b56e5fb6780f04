"""The port's dense decoder LMs and the RG-LRU hybrid (glm4-9b, qwen3-32b,
qwen2.5-32b, gemma-2b, gemma-2b-sw, recurrentgemma-9b) against the JAX
package's, on the CPU, at each architecture's ``reduced()`` size (2
layers, 3 for the hybrid's pattern; d = 256, 4 heads of 64, vocabulary
512, recurrentgemma's local window 32, gemma-2b-sw's window 64), and at
full size on the ``meta`` device (shapes and FLOPs, nothing allocated).

Both sides start from the same weights: the reference's ``init_params`` of
``PRNGKey(0)`` with every norm scale and bias redrawn around its init (so
that qk-norm and the QKV bias count), handed over bit for bit through
``convert.lm_params_from_jax``. Tokens are drawn with numpy.

Tolerances are the port's LM gates (``tests/test_torch_lm.py``,
``tests/test_torch_lm_train.py``): logits ``rtol=1e-4, atol=1e-4``; the
loss within ``rel=1e-4`` and every gradient leaf within ``rtol=5e-3,
atol=1e-4`` (the reference's own gradient gate,
``tests/test_perf_variants.py``); in bf16 the port's logits within the
reference's own |bf16 - fp32| error. Greedy token ids must be ``==``.

Decode runs 40 tokens, past recurrentgemma's reduced window of 32. Each
step is held against JAX's decode while ``pos`` is below the cache's
rows; the last logits are held against JAX's ``forward`` of the 40 tokens,
because the reference's window-sized cache clamps its write past the
window (ROADMAP, known faults on the reference side), and its decode is
then no yardstick.
"""
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import specs as jspecs
from repro.launch import train as j_train_cli
from repro.nn import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import ARCHS, UNPORTED, get_arch
from repro_torch.launch import specs
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads, make_prefill_step
from repro_torch.nn import transformer as T
from repro_torch.serving import Request, ServeEngine

NAMES = ["glm4-9b", "qwen3-32b", "qwen2.5-32b", "gemma-2b", "gemma-2b-sw",
         "recurrentgemma-9b"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
DECODE = 40


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def redraw_norms_and_biases(tree, seed=0):
    """The JAX tree with every norm ``scale`` redrawn as ``1 + 0.1 N`` and
    every QKV bias as ``0.1 N`` (the reference initializes them to 1 and
    0)."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        last = str(getattr(path[-1], "key", ""))
        if last == "scale":
            return jnp.asarray(1 + 0.1 * rng.normal(size=a.shape), a.dtype)
        if last in ("b_q", "b_k", "b_v"):
            return jnp.asarray(0.1 * rng.normal(size=a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


_MODELS = {}


def models(name):
    """``(jcfg, cfg, JAX params, port params)`` of ``name`` reduced, same
    weights; made once a module."""
    if name not in _MODELS:
        jcfg = j_get_arch(name).reduced()
        cfg = get_arch(name).reduced()
        jp = redraw_norms_and_biases(
            JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
        tp = convert.lm_params_from_jax(np_tree(jp), cfg, device="cpu")
        _MODELS[name] = (jcfg, cfg, jp, tp)
    return _MODELS[name]


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ---------------------------------------------------------------------- #
# configurations and shapes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_the_reference_field_for_field(name):
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(j_get_arch(name))
    assert dataclasses.asdict(get_arch(name).reduced()) == \
        dataclasses.asdict(j_get_arch(name).reduced())


def test_registry_holds_the_ported_archs_and_names_the_rest():
    assert sorted(ARCHS) == sorted(NAMES + ["rwkv6-3b"])
    assert sorted(UNPORTED) == ["arctic-480b", "deepseek-v2-lite-16b",
                                "qwen2-vl-7b", "whisper-large-v3"]
    cfg = get_arch("glm4-9b").reduced()
    for family, item in (("moe", "item 7d"), ("encdec", "item 7e"),
                         ("vlm", "item 7e")):
        with pytest.raises(NotImplementedError, match=item):
            T.stack_plan(dataclasses.replace(cfg, arch_type=family))
    with pytest.raises(NotImplementedError, match="item 7d"):
        T.stack_plan(dataclasses.replace(cfg, use_mla=True))
    with pytest.raises(ValueError, match="no-such-family"):
        T.stack_plan(dataclasses.replace(cfg, arch_type="no-such-family"))


@pytest.mark.parametrize("name", NAMES)
def test_stack_plan_equals_the_reference(name):
    for cfg, jcfg in ((get_arch(name), j_get_arch(name)),
                      (get_arch(name).reduced(), j_get_arch(name).reduced())):
        assert T.stack_plan(cfg) == [tuple(g) for g in JT.stack_plan(jcfg)]
    if name == "recurrentgemma-9b":
        assert T.stack_plan(get_arch(name)) == [
            ("pattern", 12, True), ("rec", 1, False), ("rec", 1, False)]


def names_and_shapes(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", NAMES)
def test_full_size_shapes_and_flops_equal_the_reference(name):
    """At full size on the ``meta`` device (nothing allocated): every
    parameter's name and shape is ``abstract_params``'s, and
    ``model_flops`` is the reference's for every input shape."""
    cfg, jcfg = get_arch(name), j_get_arch(name)
    params = T.init_params(cfg, generator=None, device="meta")
    assert all(t.device.type == "meta" for _, t in T.leaves(params))
    got = {n: tuple(t.shape) for n, t in T.leaves(params)}
    assert got == names_and_shapes(jspecs.abstract_params(jcfg))
    assert specs._param_counts(cfg) == jspecs._param_counts(jcfg)
    assert specs._attention_layer_count(cfg) == \
        jspecs._attention_layer_count(jcfg)
    for shape in jspecs.INPUT_SHAPES.values():
        mine = specs.InputShape(**dataclasses.asdict(shape))
        assert specs.model_flops(cfg, mine) == jspecs.model_flops(jcfg,
                                                                  shape)


def test_glm4_prefill_flops_are_the_phase_9a_figure():
    """glm4-9b's prefill at B 4, S 2,048: 136.4 TFLOP of model FLOPs, and
    gemma-2b's train step at B 1, S 2,048: 24.8 TFLOP (the chip smoke
    run's phase 9 rates divide by these)."""
    pf = specs.model_flops(get_arch("glm4-9b"),
                           specs.InputShape("p", 2048, 4, "prefill"))
    tr = specs.model_flops(get_arch("gemma-2b"),
                           specs.InputShape("t", 2048, 1, "train"))
    assert round(pf / 1e12, 1) == 136.4 and round(tr / 1e12, 1) == 24.8


@pytest.mark.parametrize("name", NAMES)
def test_decode_cache_layout_equals_the_reference(name):
    jcfg, cfg, _, _ = models(name)
    want = names_and_shapes(JT.init_decode_cache(jcfg, 2, DECODE,
                                                 dtype=jnp.float32))
    got = {n: tuple(t.shape) for n, t in T.leaves(
        T.init_decode_cache(cfg, 2, DECODE, device="cpu",
                            dtype=torch.float32))}
    assert got == want


# ---------------------------------------------------------------------- #
# forward, loss and gradients
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_allclose_jax(name):
    jcfg, cfg, jp, tp = models(name)
    tok = tokens(cfg, 2, 24)
    jl, _ = jax.jit(JT.forward, static_argnums=1)(jp, jcfg, jnp.asarray(tok))
    tl = T.forward(tp, cfg, torch.from_numpy(tok))
    assert tl.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want = make_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(tok)})
    assert torch.equal(want, tl[:, -1])


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_allclose_jax(name):
    jcfg, cfg, jp, tp = models(name)
    tok = tokens(cfg, 2, 17, seed=1)
    raw = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in raw.items()})
    loss, aux, grads = loss_and_grads(
        tp, cfg, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    assert float(aux["nll"]) == pytest.approx(float(jaux["nll"]), rel=1e-4)
    want = convert.flatten_tree(np_tree(jg))
    assert sorted(grads) == sorted(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(grads[leaf].numpy(), w, err_msg=leaf,
                                   **GRAD_TOL)


@pytest.mark.parametrize("name", ["glm4-9b", "recurrentgemma-9b"])
def test_remat_equals_no_remat_bitwise(name):
    """Remat (per block, per pattern body for the hybrid) changes no bit
    of the loss or the gradients."""
    _, cfg, _, tp = models(name)
    tok = torch.from_numpy(tokens(cfg, 2, 17, seed=2))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    out = {r: loss_and_grads(tp, dataclasses.replace(cfg, remat=r), batch)
           for r in (True, False)}
    assert torch.equal(out[True][0], out[False][0])
    for leaf, g in out[True][2].items():
        assert torch.equal(g, out[False][2][leaf]), leaf


def test_remat_recomputes_each_pattern_body_in_the_backward(monkeypatch):
    """The hybrid's scanned pattern is rematerialized as one body (its
    three blocks run twice); unscanned layers are not."""
    _, cfg, _, _ = models("recurrentgemma-9b")
    cfg = dataclasses.replace(cfg, num_layers=5)    # 1 pattern + 2 unscanned
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    tok = torch.from_numpy(tokens(cfg, 1, 9, seed=3))
    calls = []
    block = T.block_apply
    monkeypatch.setattr(T, "block_apply",
                        lambda *a: calls.append(a[4]) or block(*a))
    for remat, want in ((True, 3 * 2 + 2), (False, 5)):
        calls.clear()
        loss_and_grads(params, dataclasses.replace(cfg, remat=remat),
                       {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
        assert len(calls) == want
    assert calls == ["rec", "rec", "attn", "rec", "rec"]


def bf16_spacing(x):
    """The distance from each value of ``x`` to the next bf16 number away
    from zero (8 bits of significand)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_logits_within_the_references_bf16_error(name):
    """The same weights rounded to bf16 on both sides: the port's bf16
    logits within the reference's own bf16 error ``e`` (its largest |bf16
    - fp32| logit) of the reference's bf16 logits, or on the bf16 number
    next to it. Both sides round each logit to bf16 last, and at |logit|
    >= 8 one bf16 spacing (0.0625) is above ``e``, so the two may land on
    neighbouring bf16 numbers there (the GeGLU archs do, at 2 to 4 of
    24,576 logits, each of |logit| 9.4-13.3); elsewhere the gate is
    ``e``."""
    jcfg, cfg, jp, tp = models(name)
    tok = tokens(cfg, 2, 24, seed=4)
    fwd = jax.jit(JT.forward, static_argnums=1)
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    jl, _ = fwd(jb, jcfg, jnp.asarray(tok))
    jf, _ = fwd(jp, jcfg, jnp.asarray(tok))
    tl = T.forward(T.map_tree(tp, lambda t: t.to(torch.bfloat16)), cfg,
                   torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    jl = np.asarray(jl.astype(jnp.float32))
    e = float(np.abs(jl - np.asarray(jf)).max())
    err = np.abs(tl.float().numpy() - jl)
    gate = np.maximum(e, bf16_spacing(jl))
    assert (err <= gate).all(), (err.max(), e, int((err > e).sum()))


# ---------------------------------------------------------------------- #
# decode and serving
# ---------------------------------------------------------------------- #
def cache_rows(cfg, seq_len):
    """The fewest rows of any attention layer's cache."""
    rows = seq_len
    for kind, _, _ in T.stack_plan(cfg):
        for kd in (cfg.hybrid_pattern if kind == "pattern" else (kind,)):
            if kd != "rec" and T._window(cfg, kd) is not None:
                rows = min(rows, T._window(cfg, kd))
    return rows


@pytest.mark.parametrize("name", NAMES)
def test_decode_40_tokens_allclose_jax(name):
    jcfg, cfg, jp, tp = models(name)
    b = 2
    tok = tokens(cfg, b, DECODE, seed=5)
    rows = cache_rows(cfg, DECODE)
    if name == "recurrentgemma-9b":
        assert rows == 32 < DECODE          # the ring turns
    jc = JT.init_decode_cache(jcfg, b, DECODE, dtype=jnp.float32)
    tc = T.init_decode_cache(cfg, b, DECODE, device="cpu",
                             dtype=torch.float32)
    j_step = jax.jit(JT.decode_step, static_argnums=1)
    for t in range(DECODE):
        tl, tc = T.decode_step(tp, cfg, torch.from_numpy(tok[:, t:t + 1]),
                               tc, torch.full((b,), t))
        if t < rows:
            jl, jc = j_step(jp, jcfg, jnp.asarray(tok[:, t:t + 1]), jc,
                            jnp.full((b,), t, jnp.int32))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"pos {t}", **LOGIT_TOL)
    full, _ = jax.jit(JT.forward, static_argnums=1)(jp, jcfg,
                                                     jnp.asarray(tok))
    np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(full)[:, -1],
                               **LOGIT_TOL)


def requests(cls, cfg, n, new_tokens=6, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, cfg.vocab_size, size=1 + i % 5)
                .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n)]


@pytest.mark.parametrize("name", NAMES)
def test_serve_engine_tokens_equal_jax(name):
    """max_seq 32: no cache passes its window, so the reference's engine
    is a yardstick."""
    jcfg, cfg, jp, tp = models(name)
    want = JServeEngine(jcfg, jp, slots=2, max_seq=32).run(
        requests(JRequest, jcfg, 5))
    got = ServeEngine(cfg, tp, slots=2, max_seq=32).run(
        requests(Request, cfg, 5))
    for g, w in zip(got, want):
        assert g.output == w.output
        assert (g.done, g.truncated) == (w.done, w.truncated) == (True, False)


# ---------------------------------------------------------------------- #
# the training CLI
# ---------------------------------------------------------------------- #
def reference_cli_losses(monkeypatch, argv):
    """The step losses ``repro.launch.train`` prints for ``argv``."""
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    j_train_cli.main()
    monkeypatch.undo()
    return [float(x) for x in re.findall(r"loss=([-\d.]+)", out.getvalue())]


@pytest.mark.parametrize("name", ["glm4-9b", "recurrentgemma-9b"])
def test_cli_train_lm_losses_allclose_reference(name, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch NAME --steps 3 --batch 2
    --seq 16 --device cpu`` against ``repro.launch.train``'s same command,
    both from the JAX weights of seed 0 (the port's own draw is a torch
    generator's): the losses within ``rtol=1e-4``."""
    argv = ["--arch", name, "--steps", "3", "--batch", "2", "--seq", "16"]
    want = reference_cli_losses(monkeypatch, argv)
    jcfg = j_get_arch(name).reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = convert.lm_params_from_jax(np_tree(jp), get_arch(name).reduced(),
                                    device="cpu")
    monkeypatch.setattr(T, "init_params", lambda cfg, **kw: tp)
    losses = train_cli.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jp))
    assert f"[train] {name}-smoke: {n:,} params" in printed
    assert len(losses) == len(want) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=5e-5)
