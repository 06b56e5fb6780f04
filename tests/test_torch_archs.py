"""The port's LM architectures against the JAX package's, on the CPU: the
dense decoder LMs (glm4-9b, qwen3-32b, qwen2.5-32b, gemma-2b, gemma-2b-sw),
the RG-LRU hybrid (recurrentgemma-9b), the MoE LMs (arctic-480b;
deepseek-v2-lite-16b with MLA), the whisper encoder-decoder backbone and
the qwen2-vl backbone (M-RoPE, vision embeddings), at each architecture's
``reduced()`` size (2 layers, 3 for the hybrid's pattern; d = 256, 4 heads
of 64, vocabulary 512, 4 experts, 32 encoder frames, recurrentgemma's local
window 32, gemma-2b-sw's window 64), and at full size on the ``meta``
device (shapes and FLOPs, nothing allocated). The MoE archs run again
under ``moe_dispatch="capacity"`` (``NAME:capacity``; arctic's reduced
capacity drops tokens, deepseek's 4-of-4 routing does not), and whisper
decodes again with its cross-attention k and v cached
(``whisper-large-v3:cross_kv``).

Both sides start from the same weights: the reference's ``init_params`` of
``PRNGKey(0)`` with every norm scale and bias redrawn around its init (so
that qk-norm and the QKV bias count), handed over bit for bit through
``convert.lm_params_from_jax``. Tokens, frame embeddings, vision
embeddings and 3-D positions are drawn with numpy. Before an MoE arch's
logits are compared, each MoE layer's experts (for the router inputs the
port's forward gives it) must be the reference router's, token for token.

Tolerances are the port's LM gates (``tests/test_torch_lm.py``,
``tests/test_torch_lm_train.py``): logits ``rtol=1e-4, atol=1e-4``; the
loss and the MoE aux within ``rel=1e-4`` and every gradient leaf within
``rtol=5e-3, atol=1e-4`` (the reference's own gradient gate,
``tests/test_perf_variants.py``); in bf16 the port's logits within the
reference's own |bf16 - fp32| error. Greedy token ids must be ``==``.

Decode runs 40 tokens, past recurrentgemma's reduced window of 32. Each
step is held against JAX's decode while ``pos`` is below the cache's
rows; the last logits are held against JAX's ``forward`` of the 40 tokens,
because the reference's window-sized cache clamps its write past the
window (ROADMAP, known faults on the reference side), and its decode is
then no yardstick. Whisper decodes against its encoder's output of the
frames its ``forward`` is given, qwen2-vl at 3-D positions ``t``.
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

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.launch import specs as jspecs
from repro.launch import train as j_train_cli
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import ARCHS, UNPORTED, get_arch
from repro_torch.launch import specs
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads, make_prefill_step
from repro_torch.nn import attention as A
from repro_torch.nn import moe as M
from repro_torch.nn import transformer as T
from repro_torch.serving import Request, ServeEngine

NEW = ["arctic-480b", "deepseek-v2-lite-16b", "whisper-large-v3",
       "qwen2-vl-7b"]
NAMES = ["glm4-9b", "qwen3-32b", "qwen2.5-32b", "gemma-2b", "gemma-2b-sw",
         "recurrentgemma-9b"] + NEW
MOE = ["arctic-480b", "deepseek-v2-lite-16b"]
CAPACITY = [f"{name}:capacity" for name in MOE]
RUNS = NAMES + CAPACITY          # forward, loss, decode and serving
VARIANTS = {"capacity": dict(moe_dispatch="capacity"),
            "cross_kv": dict(cache_cross_kv=True)}
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
    weights; made once a module. ``NAME:VARIANT`` is ``NAME`` with
    ``VARIANTS[VARIANT]`` on both configs and the same weights."""
    if name not in _MODELS:
        base, _, variant = name.partition(":")
        if variant:
            jcfg, cfg, jp, tp = models(base)
            change = VARIANTS[variant]
            _MODELS[name] = (dataclasses.replace(jcfg, **change),
                             dataclasses.replace(cfg, **change), jp, tp)
        else:
            jcfg = j_get_arch(name).reduced()
            cfg = get_arch(name).reduced()
            jp = redraw_norms_and_biases(
                JT.init_params(jax.random.PRNGKey(0), jcfg,
                               dtype=jnp.float32))
            tp = convert.lm_params_from_jax(np_tree(jp), cfg, device="cpu")
            _MODELS[name] = (jcfg, cfg, jp, tp)
    return _MODELS[name]


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def extras(cfg, b, s, seed=0):
    """The inputs beside the tokens, as numpy: whisper's frame embeddings
    ``(B, F, d)``; qwen2-vl's vision embeddings ``(B, S, vision_dim)`` and
    3-D positions (time, then a 4-wide grid's row and column), so that
    M-RoPE's three sections see three position streams."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.arch_type == "encdec":
        out["audio_frames"] = rng.normal(
            size=(b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = (0.5 * rng.normal(
            size=(b, s, cfg.vision_dim))).astype(np.float32)
        t = np.arange(s)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4], -1)[None], (b, s, 3)).copy()
    return out


def jax_in(x, dtype=None):
    x = {k: jnp.asarray(v) for k, v in x.items()}
    if dtype is not None:
        x = {k: v.astype(dtype) if v.dtype == jnp.float32 else v
             for k, v in x.items()}
    return x


def torch_in(x, dtype=None):
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    if dtype is not None:
        x = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in x.items()}
    return x


def routed_experts(monkeypatch):
    """Record each MoE layer's router input and the experts the port picks
    for it: ``[(x (T, d), top_idx (T, k))]``."""
    seen = []
    route = M._route

    def recording(p, x, top_k):
        probs, vals, idx = route(p, x, top_k)
        seen.append((p["router"].detach().numpy(), x.detach().numpy(),
                     idx.numpy()))
        return probs, vals, idx
    monkeypatch.setattr(M, "_route", recording)
    return seen


def assert_reference_routing(seen, top_k):
    """The reference router (``x @ router``, softmax, ``lax.top_k``) on
    each recorded input picks the port's experts, token for token."""
    assert seen
    for layer, (router, x, idx) in enumerate(seen):
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, axis=-1))
        want = np.asarray(jax.lax.top_k(jnp.asarray(probs), top_k)[1])
        bad = np.nonzero((idx != want).any(-1))[0]
        if bad.size:
            p = np.sort(probs[bad], axis=-1)[:, ::-1]
            gap = (p[:, top_k - 1] - p[:, top_k] if top_k < p.shape[1]
                   else 0)
            raise AssertionError(f"MoE call {layer}: tokens {bad.tolist()} "
                                 f"pick other experts than the reference; "
                                 f"k-th minus (k+1)-th probability {gap}")


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
    """Every architecture of the reference's registry resolves, and none is
    left unported."""
    assert sorted(ARCHS) == sorted(J_ARCHS) == sorted(NAMES + ["rwkv6-3b"])
    assert UNPORTED == {}
    for name in J_ARCHS:
        assert get_arch(name) is ARCHS[name]
    cfg = get_arch("glm4-9b").reduced()
    with pytest.raises(ValueError, match="no-such-family"):
        T.stack_plan(dataclasses.replace(cfg, arch_type="no-such-family"))
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("name", NAMES)
def test_stack_plan_equals_the_reference(name):
    for cfg, jcfg in ((get_arch(name), j_get_arch(name)),
                      (get_arch(name).reduced(), j_get_arch(name).reduced())):
        assert T.stack_plan(cfg) == [tuple(g) for g in JT.stack_plan(jcfg)]
    if name == "recurrentgemma-9b":
        assert T.stack_plan(get_arch(name)) == [
            ("pattern", 12, True), ("rec", 1, False), ("rec", 1, False)]
    if name == "deepseek-v2-lite-16b":
        assert T.stack_plan(get_arch(name)) == [("dense", 1, False),
                                                 ("moe", 26, True)]


def names_and_shapes(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def branch_params(cfg):
    """The MoE layers' shared-expert and dense-branch parameters."""
    return sum(t.numel() for n, t in T.leaves(T.init_params(
        cfg, generator=None, device="meta"))
        if ".moe.shared." in n or ".moe.dense." in n)


@pytest.mark.parametrize("name", NAMES)
def test_full_size_shapes_and_flops_equal_the_reference(name, monkeypatch):
    """At full size on the ``meta`` device (nothing allocated): every
    parameter's name and shape is ``abstract_params``'s. The parameter
    counts are the reference's, except that the port discounts only the
    routed experts (the reference also discounts the MoE layers' shared
    experts and dense branch: ROADMAP, known faults on the reference
    side), and ``model_flops`` is the reference's formula of those counts
    for every input shape."""
    cfg, jcfg = get_arch(name), j_get_arch(name)
    params = T.init_params(cfg, generator=None, device="meta")
    assert all(t.device.type == "meta" for _, t in T.leaves(params))
    got = {n: tuple(t.shape) for n, t in T.leaves(params)}
    assert got == names_and_shapes(jspecs.abstract_params(jcfg))
    total, active = specs._param_counts(cfg)
    j_total, j_active = jspecs._param_counts(jcfg)
    assert total == j_total
    missed = (1 - cfg.top_k / cfg.num_experts) * branch_params(cfg) \
        if cfg.num_experts else 0
    assert active == pytest.approx(j_active + missed, rel=1e-12)
    assert (missed > 0) == (name in MOE)
    assert specs._attention_layer_count(cfg) == \
        jspecs._attention_layer_count(jcfg)
    monkeypatch.setattr(jspecs, "_param_counts", lambda _: (total, active))
    for shape in jspecs.INPUT_SHAPES.values():
        mine = specs.InputShape(**dataclasses.asdict(shape))
        assert specs.model_flops(cfg, mine) == jspecs.model_flops(jcfg,
                                                                  shape)


def test_reference_discounts_the_shared_and_dense_branches():
    """The two figures of each MoE arch (active parameters, embeddings and
    head excluded): the port's, routed experts at top_k / E, against the
    reference's, which counts the stacked shared experts (deepseek: 0.450
    B at 6/64) and dense branch (arctic: 3.661 B at 2/128) at that rate
    too."""
    figures = {"deepseek-v2-lite-16b": (2.242, 1.834, 0.450),
               "arctic-480b": (15.126, 11.522, 3.661)}
    for name, (mine, ref, branch) in figures.items():
        cfg = get_arch(name)
        assert round(specs._param_counts(cfg)[1] / 1e9, 3) == mine
        assert round(jspecs._param_counts(j_get_arch(name))[1] / 1e9,
                     3) == ref
        assert round(branch_params(cfg) / 1e9, 3) == branch


def test_glm4_prefill_flops_are_the_phase_9a_figure():
    """glm4-9b's prefill at B 4, S 2,048: 136.4 TFLOP of model FLOPs, and
    gemma-2b's train step at B 1, S 2,048: 24.8 TFLOP (the chip smoke
    run's phase 9 rates divide by these)."""
    pf = specs.model_flops(get_arch("glm4-9b"),
                           specs.InputShape("p", 2048, 4, "prefill"))
    tr = specs.model_flops(get_arch("gemma-2b"),
                           specs.InputShape("t", 2048, 1, "train"))
    assert round(pf / 1e12, 1) == 136.4 and round(tr / 1e12, 1) == 24.8


@pytest.mark.parametrize("name", NAMES + ["whisper-large-v3:cross_kv"])
def test_decode_cache_layout_equals_the_reference(name):
    jcfg, cfg, _, _ = models(name)
    want = names_and_shapes(JT.init_decode_cache(jcfg, 2, DECODE,
                                                 dtype=jnp.float32))
    got = {n: tuple(t.shape) for n, t in T.leaves(
        T.init_decode_cache(cfg, 2, DECODE, device="cpu",
                            dtype=torch.float32))}
    assert got == want


@pytest.mark.parametrize("name", NEW)
def test_convert_carries_the_tree_bitwise_and_the_router_stays_fp32(name):
    """``lm_params_from_jax`` and back: every leaf bit for bit; the MoE
    routers are fp32, also in the port's own bf16 draw."""
    _, cfg, jp, tp = models(name)
    want = convert.flatten_tree(np_tree(jp))
    back = convert.flatten_tree(convert.lm_params_to_jax(tp))
    assert sorted(back) == sorted(want)
    for leaf, w in want.items():
        assert back[leaf].dtype == w.dtype == np.float32
        np.testing.assert_array_equal(back[leaf].view(np.int32),
                                      w.view(np.int32))
    bf16 = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.bfloat16)
    routers = [n for n, _ in T.leaves(bf16) if n.endswith(".router")]
    assert len(routers) == (1 if name in MOE else 0)   # one stacked group
    for n, t in T.leaves(bf16):
        assert t.dtype == (torch.float32 if n.endswith(".router")
                           else torch.bfloat16), n


# ---------------------------------------------------------------------- #
# forward, loss and gradients
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", RUNS)
def test_forward_logits_allclose_jax(name, monkeypatch):
    jcfg, cfg, jp, tp = models(name)
    tok = tokens(cfg, 2, 24)
    x = extras(cfg, 2, 24)
    seen = routed_experts(monkeypatch)
    jl, _ = jax.jit(JT.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(tok), **jax_in(x))
    tl = T.forward(tp, cfg, torch.from_numpy(tok), **torch_in(x))
    if cfg.num_experts:
        assert len(seen) == cfg.num_layers - cfg.first_k_dense
        assert_reference_routing(seen, cfg.top_k)
    assert tl.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want = make_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(tok),
                                       **torch_in(x)})
    assert torch.equal(want, tl[:, -1])


@pytest.mark.parametrize("name", RUNS)
def test_loss_and_every_gradient_allclose_jax(name):
    jcfg, cfg, jp, tp = models(name)
    tok = tokens(cfg, 2, 17, seed=1)
    raw = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
           **extras(cfg, 2, 16, seed=1)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
        jp, jax_in(raw))
    loss, aux, grads = loss_and_grads(tp, cfg, torch_in(raw))
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    assert float(aux["nll"]) == pytest.approx(float(jaux["nll"]), rel=1e-4)
    assert float(aux["moe_aux"]) == pytest.approx(float(jaux["moe_aux"]),
                                                  rel=1e-4)
    assert (float(aux["moe_aux"]) > 0) == bool(cfg.num_experts)
    want = convert.flatten_tree(np_tree(jg))
    assert sorted(grads) == sorted(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(grads[leaf].numpy(), w, err_msg=leaf,
                                   **GRAD_TOL)
    for leaf, g in grads.items():
        if leaf.endswith(".router"):
            assert float(g.abs().max()) > 0, leaf


@pytest.mark.parametrize("name", ["glm4-9b", "recurrentgemma-9b"] + NEW)
def test_remat_equals_no_remat_bitwise(name):
    """Remat (per block, per pattern body for the hybrid) changes no bit
    of the loss or the gradients."""
    _, cfg, _, tp = models(name)
    tok = torch.from_numpy(tokens(cfg, 2, 17, seed=2))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             **torch_in(extras(cfg, 2, 16, seed=2))}
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


def bf16_tree(tree, cast):
    """``tree`` with every leaf but an MoE ``router`` cast to bf16: the
    reference's bf16 trees keep the routers fp32 (``repro/nn/moe.py``)."""
    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, name) for v in t]
        return t if name == "router" else cast(t)
    return walk(tree)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_logits_within_the_references_bf16_error(name):
    """The same weights rounded to bf16 on both sides (the MoE routers
    kept fp32, as the reference draws them), the frame and vision
    embeddings too: the port's bf16 logits within the reference's own bf16
    error ``e`` (its largest |bf16 - fp32| logit) of the reference's bf16
    logits, or on the bf16 number next to it. Both sides round each logit
    to bf16 last, and at |logit| >= 8 one bf16 spacing (0.0625) is above
    ``e``, so the two may land on neighbouring bf16 numbers there (the
    GeGLU archs do, at 2 to 4 of 24,576 logits, each of |logit| 9.4-13.3);
    elsewhere the gate is ``e``."""
    jcfg, cfg, jp, tp = models(name)
    tok = tokens(cfg, 2, 24, seed=4)
    x = extras(cfg, 2, 24, seed=4)
    fwd = jax.jit(JT.forward, static_argnums=1)
    jb = bf16_tree(jp, lambda a: a.astype(jnp.bfloat16))
    jl, _ = fwd(jb, jcfg, jnp.asarray(tok), **jax_in(x, jnp.bfloat16))
    rounded = {k: (np.asarray(jnp.asarray(v, jnp.bfloat16)
                              .astype(jnp.float32))
                   if v.dtype == np.float32 else v) for k, v in x.items()}
    jf, _ = fwd(jp, jcfg, jnp.asarray(tok), **jax_in(rounded))
    tl = T.forward(bf16_tree(tp, lambda t: t.to(torch.bfloat16)), cfg,
                   torch.from_numpy(tok), **torch_in(x, torch.bfloat16))
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


def j_encode(jp, jcfg, frames):
    """The reference's encoder half of ``forward``: the ``enc`` group at
    positions 0..F-1, then the encoder's final norm."""
    pos = jnp.broadcast_to(jnp.arange(frames.shape[1])[None],
                           frames.shape[:2])
    eh, _ = JT._run_group(jp["encoder"]["groups"][0], jcfg, frames, pos,
                          "enc", True)
    return JL.rmsnorm(jp["encoder"]["final_norm"], eh)


def set_encoder_out(jcfg, cfg, jp, tp, jc, tc, frames):
    """Both caches attend to their own encoder's output of ``frames``;
    with ``cache_cross_kv`` each decoder layer's cross-attention k and v
    are filled from it (``attention.cross_kv_cache``), as the reference's
    own cached-decode test fills them."""
    jenc = jax.jit(j_encode, static_argnums=1)(jp, jcfg, jnp.asarray(frames))
    tenc = T.encode(tp, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **LOGIT_TOL)
    jc["encoder_out"] = jenc
    tc["encoder_out"] = tenc
    if not cfg.cache_cross_kv:
        return
    kw = dict(num_kv_heads=cfg.num_heads, head_dim=cfg.resolved_head_dim)
    jc["groups"][0]["cross_kv"] = jax.vmap(lambda lp: JA.cross_kv_cache(
        lp["cross_attn"], jenc, **kw))(jp["groups"][0])
    kv = tc["groups"][0]["cross_kv"]
    for i in range(cfg.num_layers):
        lp = T.layer_params(tp["groups"][0], i)
        for k, v in A.cross_kv_cache(lp["cross_attn"], tenc, **kw).items():
            kv[k][i] = v


@pytest.mark.parametrize("name", RUNS + ["whisper-large-v3:cross_kv"])
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
    x = extras(cfg, b, DECODE, seed=5)
    if cfg.arch_type == "encdec":
        set_encoder_out(jcfg, cfg, jp, tp, jc, tc, x["audio_frames"])
    j_step = jax.jit(JT.decode_step, static_argnums=1)
    for t in range(DECODE):
        at = {}
        if cfg.m_rope:
            at = {"positions_3d": np.full((b, 1, 3), t)}
        tl, tc = T.decode_step(tp, cfg, torch.from_numpy(tok[:, t:t + 1]),
                               tc, torch.full((b,), t), **torch_in(at))
        if t < rows:
            jl, jc = j_step(jp, jcfg, jnp.asarray(tok[:, t:t + 1]), jc,
                            jnp.full((b,), t, jnp.int32), **jax_in(at))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"pos {t}", **LOGIT_TOL)
    x.pop("vision_embeds", None)
    x.pop("positions", None)              # M-RoPE's default: t on all three
    full, _ = jax.jit(JT.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(tok), **jax_in(x))
    np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(full)[:, -1],
                               **LOGIT_TOL)


def requests(cls, cfg, n, new_tokens=6, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, cfg.vocab_size, size=1 + i % 5)
                .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n)]


@pytest.mark.parametrize("name", RUNS)
def test_serve_engine_tokens_equal_jax(name):
    """max_seq 32: no cache passes its window, so the reference's engine
    is a yardstick. Whisper serves against zero frames, as the reference's
    engine does (it runs no encoder)."""
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


@pytest.mark.parametrize("name", ["glm4-9b", "recurrentgemma-9b"] + NEW)
def test_cli_train_lm_losses_allclose_reference(name, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch NAME --steps 3 --batch 2
    --seq 16 --device cpu`` against ``repro.launch.train``'s same command,
    both from the JAX weights of seed 0 (the port's own draw is a torch
    generator's): the losses within ``rtol=1e-4``. qwen2-vl trains with
    the reference's zero vision embeddings and 3-D positions, whisper with
    its zero frames, the MoE archs with their aux in the loss."""
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
