"""The port's LM substrate (``repro_torch.nn``, ``configs``,
``launch.steps``, ``launch.specs``, ``serving.engine``, ``convert``)
against the JAX package's, on the CPU, at the reduced ``rwkv6-3b``
(``ArchConfig.reduced()``: 2 layers, d = 256, 4 heads of 64, vocabulary
512) and smaller.

Both sides start from the JAX weights, handed over bit for bit through
``convert.lm_params_from_jax``; inputs are drawn with numpy. On the CPU
the port's ``"chunked_kernel"`` mode runs the WKV kernel's plain version;
the JAX side runs the Pallas kernel in interpret mode.

Tolerances: the time mix, fp32 on both sides in different summation
orders, is held to ``rtol=1e-4, atol=1e-5`` (the reference's gate for its
kernel mode against the sequential scan, ``tests/test_perf_variants.py``);
the reduced model's logits, two layers of it plus the head, to
``rtol=1e-4, atol=1e-4``; in bf16, the reference's default dtype, the
port's logits within the reference's own bf16 error (its largest |bf16 -
fp32| logit). Greedy token ids must be ``==``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import specs as jspecs
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models.decoders import init_decoder_params as j_init_decoder
from repro.nn import recurrent as JR
from repro.nn import transformer as JT
from repro.serving import KGEServer as JKGEServer
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro.configs import ASSIGNED
from repro_torch.configs import UNPORTED, get_arch
from repro_torch.launch import specs
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.nn import recurrent as R
from repro_torch.nn import transformer as T
from repro_torch.serving import KGEServer, Request, ServeEngine
from repro_torch.training.optimizer import adam

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MODES = ("sequential", "chunked", "chunked_kernel")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The reduced rwkv6-3b (chunk 8) on both sides, same weights."""
    jcfg = dataclasses.replace(j_get_arch("rwkv6-3b").reduced(),
                               rwkv_chunk=8)
    cfg = dataclasses.replace(get_arch("rwkv6-3b").reduced(), rwkv_chunk=8)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = convert.lm_params_from_jax(np_tree(jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def mix_params():
    """One time-mix layer, d = 32, 4 heads of 8."""
    jp = JR.rwkv_params(jax.random.PRNGKey(0), 32, 8)
    tp = {k: (torch.from_numpy(np.asarray(v).copy()) if k != "ln_x" else
              {"scale": torch.from_numpy(np.asarray(v["scale"]).copy())})
          for k, v in jp.items()}
    return jp, tp


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ---------------------------------------------------------------------- #
# the time mix
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("form,s,chunk", [
    ("rwkv_apply", 32, None), ("rwkv_apply_chunked", 32, 8),
    ("rwkv_apply_chunked", 32, 16), ("rwkv_apply_kernel", 32, 16),
    ("rwkv_apply_kernel", 30, 16), ("rwkv_apply_kernel", 13, 8)])
def test_time_mix_forms_allclose_jax(mix_params, form, s, chunk):
    jp, tp = mix_params
    x = np.random.default_rng(s).normal(size=(2, s, 32)).astype(np.float32)
    kw = {} if chunk is None else {"chunk": chunk}
    want = getattr(JR, form)(jp, jnp.asarray(x), 8, **kw)
    got = getattr(R, form)(tp, torch.from_numpy(x), 8, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_chunked_form_rejects_a_ragged_sequence(mix_params):
    _, tp = mix_params
    with pytest.raises(ValueError, match="multiple of chunk"):
        R.rwkv_apply_chunked(tp, torch.zeros(1, 12, 32), 8, chunk=8)


def test_decode_steps_allclose_jax_and_the_scan(mix_params):
    """rwkv_decode token by token: each step's output and state against
    JAX's, and the outputs together against the port's full scan."""
    jp, tp = mix_params
    x = np.random.default_rng(1).normal(size=(2, 10, 32)).astype(np.float32)
    js = JR.rwkv_init_state(2, 32, 8)
    ts = R.rwkv_init_state(2, 32, 8)
    outs = []
    for t in range(10):
        jo, js = JR.rwkv_decode(jp, jnp.asarray(x[:, t:t + 1]), js, 8)
        to, ts = R.rwkv_decode(tp, torch.from_numpy(x[:, t:t + 1]), ts, 8)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL)
        for key in ("wkv", "x_prev"):
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                       **LAYER_TOL)
        outs.append(to)
    full = R.rwkv_apply(tp, torch.from_numpy(x), 8)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------- #
# the reduced model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_allclose_jax(models, mode):
    jcfg, cfg, jp, tp = models
    tok = tokens(cfg, 2, 32)
    jl, _ = JT.forward(jp, dataclasses.replace(jcfg, rwkv_mode=mode),
                       jnp.asarray(tok))
    tl = T.forward(tp, dataclasses.replace(cfg, rwkv_mode=mode),
                   torch.from_numpy(tok))
    assert tl.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_chunked_mode_falls_back_to_the_scan_on_a_ragged_sequence(models):
    """The reference's mode rule: "chunked" runs only when S is a multiple
    of the chunk; otherwise it is the sequential scan, bit for bit."""
    _, cfg, _, tp = models
    tok = torch.from_numpy(tokens(cfg, 2, 13))
    chunked = T.forward(tp, dataclasses.replace(cfg, rwkv_mode="chunked"),
                        tok)
    seq = T.forward(tp, cfg, tok)
    assert torch.equal(chunked, seq)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_step_last_logits_and_argmax_equal_jax(models, mode):
    jcfg, cfg, jp, tp = models
    tok = tokens(cfg, 3, 24, seed=1)
    want = j_make_prefill_step(dataclasses.replace(jcfg, rwkv_mode=mode))(
        jp, {"tokens": jnp.asarray(tok)})
    got = make_prefill_step(dataclasses.replace(cfg, rwkv_mode=mode))(
        tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    last, arg = T.prefill(tp, dataclasses.replace(cfg, rwkv_mode=mode),
                          torch.from_numpy(tok))
    assert torch.equal(last, got)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want).argmax(-1))


def test_decode_step_over_24_tokens_allclose_jax(models):
    jcfg, cfg, jp, tp = models
    tok = tokens(cfg, 2, 24, seed=2)
    jc = JT.init_decode_cache(jcfg, 2, 32, dtype=jnp.float32)
    tc = T.init_decode_cache(cfg, 2, 32, device="cpu", dtype=torch.float32)
    j_step = jax.jit(JT.decode_step, static_argnums=1)
    for t in range(24):
        pos = np.full((2,), t)
        jl, jc = j_step(jp, jcfg, jnp.asarray(tok[:, t:t + 1]), jc,
                        jnp.asarray(pos))
        tl, tc = T.decode_step(tp, cfg, torch.from_numpy(tok[:, t:t + 1]),
                               tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want = convert.flatten_tree(np_tree(jc))
    got = dict(T.leaves(tc))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, **LOGIT_TOL)


def test_decode_of_a_prompt_ends_at_the_kernel_prefill(models):
    """Feeding a prompt through decode_step (no kernel) gives the last
    logits of the kernel-mode prefill: the port's counterpart of the
    full-width gate in chip_smoke.py phase 8b."""
    _, cfg, _, tp = models
    tok = torch.from_numpy(tokens(cfg, 2, 20, seed=3))
    kcfg = dataclasses.replace(cfg, rwkv_mode="chunked_kernel")
    want = make_prefill_step(kcfg)(tp, {"tokens": tok})
    cache = T.init_decode_cache(cfg, 2, 20, device="cpu",
                                dtype=torch.float32)
    for t in range(20):
        logits, cache = T.decode_step(tp, cfg, tok[:, t:t + 1], cache,
                                      torch.full((2,), t))
    torch.testing.assert_close(logits[:, 0], want, **LOGIT_TOL)


def to_bf16(tree):
    return {k: to_bf16(v) if isinstance(v, dict) else
            [to_bf16(g) for g in v] if isinstance(v, list) else
            v.to(torch.bfloat16) for k, v in tree.items()}


@pytest.mark.parametrize("mode", MODES)
def test_bf16_forward_logits_allclose_jax_bf16(models, mode):
    """bf16 weights, the reference's default dtype: the same fp32 weights
    rounded to bf16 on both sides (round to nearest even, the same bits),
    then both forwards in bf16 around the fp32 WKV core. The two sides
    round different intermediates, so the port's logits are held to JAX's
    within the reference's own bf16 error at these inputs: the largest
    |JAX bf16 - JAX fp32| logit."""
    jcfg, cfg, jp, tp = models
    jcfg, cfg = (dataclasses.replace(c, rwkv_mode=mode) for c in (jcfg, cfg))
    tok = tokens(cfg, 2, 32)
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = to_bf16(tp)
    want = convert.flatten_tree(jb)
    for name, t in T.leaves(tb):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      want[name].view(np.int16))
    jl, _ = JT.forward(jb, jcfg, jnp.asarray(tok))
    jf, _ = JT.forward(jp, jcfg, jnp.asarray(tok))
    tl = T.forward(tb, cfg, torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    jl = np.asarray(jl.astype(jnp.float32))
    atol = float(np.abs(jl - np.asarray(jf)).max())
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0, atol=atol)


def test_bf16_init_is_the_fp32_draw_rounded():
    """init_params(dtype=torch.bfloat16) draws the fp32 values from the
    same generator and rounds each to bf16."""
    cfg = get_arch("rwkv6-3b").reduced()
    f32 = T.init_params(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu", dtype=torch.float32)
    bf16 = T.init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu", dtype=torch.bfloat16)
    got, want = T.leaves(bf16), T.leaves(f32)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, b), (_, f) in zip(got, want):
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, f.to(torch.bfloat16))


def test_init_params_default_dtype_is_the_references():
    """The port's init_params defaults to the reference's dtype, bfloat16
    (repro.nn.transformer.init_params), every leaf of the tree."""
    cfg = get_arch("rwkv6-3b").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    jp = JT.init_params(jax.random.PRNGKey(0), j_get_arch("rwkv6-3b")
                        .reduced())
    want = {jnp.dtype(a.dtype) for a in jax.tree_util.tree_leaves(jp)}
    assert want == {jnp.dtype(jnp.bfloat16)}
    assert {t.dtype for _, t in T.leaves(params)} == {torch.bfloat16}


def test_decode_runs_on_the_default_dtypes(models):
    """init_params and init_decode_cache with their defaults (both bf16,
    the reference's) make a cache that decode_step takes: the token-shift
    rows are the weights' dtype, the WKV state fp32, and the logits are
    those of the same loop on a cache made in bf16 explicitly."""
    _, cfg, _, _ = models
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    tok = torch.from_numpy(tokens(cfg, 2, 6, seed=6))
    cache = T.init_decode_cache(cfg, 2, 6, device="cpu")
    rows = cache["groups"][0]
    assert rows["cmix_x_prev"].dtype == rows["rec"]["x_prev"].dtype == \
        params["embed"].dtype == torch.bfloat16
    assert rows["rec"]["wkv"].dtype == torch.float32
    want = T.init_decode_cache(cfg, 2, 6, device="cpu", dtype=torch.bfloat16)
    for t in range(tok.shape[1]):
        pos = torch.full((2,), t)
        logits, cache = T.decode_step(params, cfg, tok[:, t:t + 1], cache,
                                      pos)
        ref, want = T.decode_step(params, cfg, tok[:, t:t + 1], want, pos)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())
        assert torch.equal(logits, ref)


@pytest.mark.parametrize("serve", [False, True])
def test_bf16_decode_tracks_the_bf16_prefill(models, serve):
    """bf16 weights through decode_step (the cache's token-shift rows in
    bf16, the WKV state fp32) and through ServeEngine: a prompt's last
    logits sit within the bf16 error of the kernel-mode bf16 prefill's (the
    largest |bf16 - fp32| prefill logit at these inputs), the chip smoke
    run's phase 8b gate at reduced width; the engine's greedy tokens (one
    slot) are those of a bf16 decode loop of one row."""
    _, cfg, _, tp = models
    tb = to_bf16(tp)
    tok = torch.from_numpy(tokens(cfg, 2, 16, seed=5))
    kcfg = dataclasses.replace(cfg, rwkv_mode="chunked_kernel")
    want = make_prefill_step(kcfg)(tb, {"tokens": tok})
    want32 = make_prefill_step(kcfg)(tp, {"tokens": tok})
    atol = float((want.float() - want32).abs().max())
    if not serve:
        cache = T.init_decode_cache(cfg, 2, 16, device="cpu",
                                    dtype=torch.bfloat16)
        for t in range(tok.shape[1]):
            logits, cache = T.decode_step(tb, cfg, tok[:, t:t + 1], cache,
                                          torch.full((2,), t))
        assert logits.dtype == torch.bfloat16
        assert cache["groups"][0]["rec"]["wkv"].dtype == torch.float32
        np.testing.assert_allclose(logits[:, 0].float().numpy(),
                                   want.float().numpy(), rtol=0, atol=atol)
        return
    reqs = requests(Request, cfg, 3, new_tokens=4)
    ServeEngine(cfg, tb, slots=1, max_seq=16).run(reqs)
    step = make_serve_step(cfg)
    for r in reqs:
        cache = T.init_decode_cache(cfg, 1, 16, device="cpu",
                                    dtype=torch.bfloat16)
        seq, out = list(r.prompt), []
        for t in range(len(r.prompt) + r.max_new_tokens - 1):
            nxt, cache = step(tb, cache, {"tokens": torch.tensor([[seq[t]]]),
                                          "pos": torch.tensor([t])})
            if t >= len(r.prompt) - 1:
                out.append(int(nxt[0]))
                seq.append(out[-1])
        assert r.done and r.output == out


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #
def requests(cls, cfg, n, new_tokens=6, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, cfg.vocab_size, size=1 + i % 5)
                .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n)]


@pytest.mark.parametrize("slots", [2, 4])
def test_serve_engine_tokens_equal_jax(models, slots):
    jcfg, cfg, jp, tp = models
    want = JServeEngine(jcfg, jp, slots=slots, max_seq=32).run(
        requests(JRequest, jcfg, 5))
    got = ServeEngine(cfg, tp, slots=slots, max_seq=32).run(
        requests(Request, cfg, 5))
    for g, w in zip(got, want):
        assert g.output == w.output
        assert (g.done, g.truncated) == (w.done, w.truncated) == (True, False)


def test_serve_engine_reports_truncation(models):
    """A request the max_seq horizon cuts off must NOT claim done
    (the reference's ``test_lm_truncation_reported``, on rwkv6-3b)."""
    _, cfg, _, tp = models
    eng = ServeEngine(cfg, tp, slots=2, max_seq=8)
    cut = Request(0, np.array([1, 2, 3]), max_new_tokens=50)
    fits = Request(1, np.array([1, 2]), max_new_tokens=3)
    eng.run([cut, fits])
    assert cut.truncated and not cut.done
    assert len(cut.output) < cut.max_new_tokens
    assert fits.done and not fits.truncated
    assert len(fits.output) == 3


def test_serve_step_is_greedy_with_first_index_ties(models):
    _, cfg, _, tp = models
    cache = T.init_decode_cache(cfg, 2, 1, device="cpu", dtype=torch.float32)
    tok, pos = torch.tensor([[3], [5]]), torch.zeros(2, dtype=torch.long)
    logits, _ = T.decode_step(tp, cfg, tok, T.init_decode_cache(
        cfg, 2, 1, device="cpu", dtype=torch.float32), pos)
    nxt, _ = make_serve_step(cfg)(tp, cache, {"tokens": tok, "pos": pos})
    assert torch.equal(nxt, logits[:, -1].argmax(-1))
    assert torch.argmax(torch.tensor([1.0, 3.0, 3.0])) == 1


@pytest.mark.parametrize("decoder", ["distmult", "transe", "complex",
                                     "rotate"])
def test_dense_kge_server_equals_jax(decoder):
    rng = np.random.default_rng(5)
    emb = rng.normal(0, 0.3, (60, 16)).astype(np.float32)
    emb[19] = emb[40] = emb[7]                # tied candidates
    p = np_tree(j_init_decoder(jax.random.PRNGKey(0), decoder, 6, 16))
    heads, rels = rng.integers(0, 60, 9), rng.integers(0, 6, 9)
    want = JKGEServer(emb, p, decoder=decoder).topk_tails(heads, rels, k=7)
    srv = KGEServer(emb, p, decoder=decoder, device="cpu")
    np.testing.assert_array_equal(srv.topk_tails(heads, rels, k=7), want)
    assert srv.topk_tails(heads[:2], rels[:2], k=1000).shape == (2, 60)
    with pytest.raises(ValueError):
        srv.topk_tails(heads, rels, k=0)


# ---------------------------------------------------------------------- #
# weights, shapes, configs
# ---------------------------------------------------------------------- #
def test_convert_round_trip_is_bitwise(models):
    _, cfg, jp, tp = models
    back = convert.lm_params_to_jax(tp)
    want = jax.tree_util.tree_flatten_with_path(np_tree(jp))[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    again = convert.lm_params_from_jax(back, cfg, device="cpu")
    for (_, a), (_, b) in zip(T.leaves(again), T.leaves(tp)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_convert_rejects_a_tree_of_another_shape(models):
    _, cfg, jp, _ = models
    tree = np_tree(jp)
    tree["groups"][0]["rec"]["w_r"] = tree["groups"][0]["rec"]["w_r"][:1]
    with pytest.raises(ValueError, match="does not match"):
        convert.lm_params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        convert.lm_params_from_jax(np_tree(jp), get_arch("rwkv6-3b"),
                                   device="cpu")


def test_full_width_shapes_and_count_from_the_meta_device():
    """rwkv6-3b at full width: every name and shape of the port's tree is
    the reference's (from jax.eval_shape), and there are 3,073,313,280
    parameters."""
    cfg = get_arch("rwkv6-3b")
    params = T.init_params(cfg, generator=None, device="meta")
    abstract = jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), j_get_arch("rwkv6-3b"), dtype=jnp.float32))
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = {n: tuple(t.shape) for n, t in T.leaves(params)}
    assert got == want
    assert T.count_params(params) == 3_073_313_280
    assert all(t.device.type == "meta" for _, t in T.leaves(params))


def test_init_moments_follow_the_reference_formulas():
    cfg = get_arch("rwkv6-3b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = T.init_params(cfg, generator=gen, device="cpu", dtype=torch.float32)
    d, v, ff = cfg.d_model, cfg.vocab_size, cfg.d_ff
    g = p["groups"][0]

    def check(t, std):
        # four standard errors of the sample mean and standard deviation
        n = t.numel()
        assert abs(float(t.mean())) < 4 * std / n ** 0.5
        assert abs(float(t.std()) / std - 1) < 4 / (2 * n) ** 0.5

    check(p["embed"], d ** -0.5)
    check(p["lm_head"], (2 / (d + v)) ** 0.5)
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        check(g["rec"][name], (2 / (2 * d)) ** 0.5)
    check(g["rec"]["decay_A"], (2 / (d + 64)) ** 0.5)
    check(g["cmix"]["w_k"], (2 / (d + ff)) ** 0.5)
    check(g["rec"]["bonus_u"], 0.1)
    assert g["rec"]["bonus_u"].shape == (2, 4, 64)
    for t, value in ((g["rec"]["mu_r"], 0.5), (g["cmix"]["mu_k"], 0.5),
                     (g["rec"]["decay_w0"], -6.0),
                     (g["rec"]["ln_x"]["scale"], 1.0),
                     (g["norm1"]["scale"], 1.0), (p["final_norm"]["scale"],
                                                  1.0)):
        assert bool((t == value).all())
    again = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu", dtype=torch.float32)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(T.leaves(p), T.leaves(again)))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_arch("rwkv6-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_decode_cache(cfg, 1, 8)


@pytest.mark.parametrize("shape", sorted(jspecs.INPUT_SHAPES))
def test_model_flops_equal_the_reference(shape):
    cfg, jcfg = get_arch("rwkv6-3b"), j_get_arch("rwkv6-3b")
    got = specs.model_flops(cfg, specs.InputShape(
        **dataclasses.asdict(jspecs.INPUT_SHAPES[shape])))
    assert got == jspecs.model_flops(jcfg, jspecs.INPUT_SHAPES[shape])
    total, active = specs._param_counts(cfg)
    assert (total, active) == (3_073_313_280, 2_737_768_960)


@pytest.mark.parametrize("name", ["arctic-480b", "deepseek-v2-lite-16b",
                                  "qwen2-vl-7b", "whisper-large-v3"])
def test_unported_architectures_raise_naming_their_item(name):
    """The four architectures that waited for ROADMAP Queue 1 items 7d and
    7e resolve now (``UNPORTED`` is empty): each is the reference's
    configuration, and its stack plan is the reference's
    (``tests/test_torch_archs.py`` holds them against ``repro``)."""
    assert name in ASSIGNED and not UNPORTED
    cfg = get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_arch(name))
    assert T.stack_plan(cfg) == [tuple(g) for g in JT.stack_plan(
        j_get_arch(name))]


def test_unknown_arch_and_other_families_raise():
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    other = dataclasses.replace(get_arch("rwkv6-3b").reduced(),
                                arch_type="no-such-family")
    with pytest.raises(ValueError, match="no-such-family"):
        T.stack_plan(other)
    # LM training runs (tests/test_torch_lm_train.py holds it against the
    # reference)
    cfg = get_arch("rwkv6-3b").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    opt = adam(1e-3)
    state = opt.init(dict(T.leaves(params)))
    tok = torch.from_numpy(tokens(cfg, 1, 9))
    _, state, m = make_train_step(cfg, opt)(
        params, state, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    assert int(state.step) == 1 and bool(torch.isfinite(m["loss"]))
