"""The port's attention, the new layers and the RG-LRU
(``repro_torch.nn.attention``, ``nn.layers``, ``nn.recurrent``'s ``rglru_*``)
against the JAX package's, function by function, on the CPU.

Inputs are drawn with numpy from a seed; parameters are the reference's own
(``repro.nn.*_params`` of a ``PRNGKey``), handed over bit for bit, with the
zero-initialized biases replaced by draws so that they count.

Tolerances: each layer ``rtol=1e-4, atol=1e-5`` (the port's LM layer gate,
``tests/test_torch_lm.py``); ``_mea`` against ``_sdpa`` at the reference's
own gate for that pair, ``rtol=2e-4, atol=2e-5``
(``tests/test_attention.py``). Both sides compute in fp32 in other
summation orders.

Two facts of the reference decide how the port is written and are pinned
here: ``jax.nn.gelu`` is the tanh form by default, so both of the
reference's gelu activations are; and its window-sized decode cache
clamps its write index, so past the window its decode no longer equals
its windowed ``attention`` (ROADMAP, known faults on the reference side),
where the port's ring buffer does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import recurrent as JR
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import recurrent as R

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
MEA_TOL = dict(rtol=2e-4, atol=2e-5)


def tt(tree):
    """A JAX parameter tree as torch tensors, bit for bit."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def draw(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
def test_layernorm_allclose_jax():
    rng = np.random.default_rng(0)
    x = draw(rng, (2, 5, 24), 3.0) + 1.5
    p = {"scale": draw(rng, (24,)), "bias": draw(rng, (24,))}
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    close(L.layernorm(tt(p), torch.from_numpy(x)), want)
    init = L.layernorm_params(24)
    assert shapes(init) == shapes(JL.layernorm_params(24))
    assert bool((init["scale"] == 1).all() and (init["bias"] == 0).all())


@pytest.mark.parametrize("hd,base", [(16, 1e4), (128, 1e4), (128, 1e6),
                                     (256, 1e4)])
def test_rope_frequencies_allclose_jax(hd, base):
    close(L.rope_frequencies(hd, base), JL.rope_frequencies(hd, base),
          dict(rtol=2e-7, atol=0))


@pytest.mark.parametrize("base", [1e4, 1e6])
def test_apply_rope_allclose_jax(base):
    """Positions up to 8,192 (the longest the card runs), fp32 angles."""
    rng = np.random.default_rng(1)
    x = draw(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 8192, (2, 7))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), base)
    close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), base),
          want)


@pytest.mark.parametrize("sections", [None, (2, 3, 3)])
def test_apply_m_rope_allclose_jax(sections):
    rng = np.random.default_rng(2)
    x = draw(rng, (2, 6, 2, 16))
    pos3 = rng.integers(0, 500, (2, 6, 3))
    want = JL.apply_m_rope(jnp.asarray(x), jnp.asarray(pos3), 1e4,
                           sections)
    close(L.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos3), 1e4,
                         sections), want)
    if sections is None:      # Qwen2-VL's split at hd = 128
        assert L.m_rope_sections(64) == (16, 24, 24)


def test_m_rope_rejects_sections_of_another_sum():
    with pytest.raises(ValueError, match="do not sum"):
        L.apply_m_rope(torch.zeros(1, 2, 1, 16),
                       torch.zeros(1, 2, 3, dtype=torch.long),
                       sections=(2, 2, 2))


def test_gelu_is_the_tanh_form_as_jax_defaults_it():
    """``jax.nn.gelu`` defaults to ``approximate=True``: the reference's
    "gelu" and "gelu_tanh" are both the tanh form, and so are the port's.
    ``F.gelu``'s default erf form is off by more than the layer gate."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_array_equal(
        want, np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)))
    for act in ("gelu", "gelu_tanh"):
        close(L.ACTIVATIONS[act](torch.from_numpy(x)), want)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 10 * LAYER_TOL["atol"]


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("glu", [True, False])
def test_mlp_apply_allclose_jax(act, glu):
    rng = np.random.default_rng(3)
    jp = JL.mlp_params(jax.random.PRNGKey(0), 32, 96, glu)
    assert shapes(L.mlp_params(torch.Generator().manual_seed(0), 32, 96,
                               glu)) == shapes(jp)
    x = draw(rng, (2, 5, 32))
    close(L.mlp_apply(tt(jp), torch.from_numpy(x), act),
          JL.mlp_apply(jp, jnp.asarray(x), act))


@pytest.mark.parametrize("cap", [None, 30.0, 2.0])
def test_softcap_allclose_jax(cap):
    x = draw(np.random.default_rng(4), (3, 50), 20.0)
    got = L.softcap(torch.from_numpy(x), cap)
    close(got, JL.softcap(jnp.asarray(x), cap), dict(rtol=1e-6, atol=1e-6))
    if cap is None:
        assert torch.equal(got, torch.from_numpy(x))


# ---------------------------------------------------------------------- #
# GQA attention
# ---------------------------------------------------------------------- #
def attn_pair(d, h, hkv, hd, bias=False, norm=False, seed=0):
    """The reference's attention parameters (biases and norm scales drawn)
    and the port's copy."""
    jp = JA.attn_params(jax.random.PRNGKey(seed), d, h, hkv, hd,
                        qkv_bias=bias, qk_norm=norm)
    rng = np.random.default_rng(seed + 100)
    for k in ("b_q", "b_k", "b_v"):
        if k in jp:
            jp[k] = jnp.asarray(draw(rng, jp[k].shape, 0.5))
    for k in ("q_norm", "k_norm"):
        if k in jp:
            jp[k] = {"scale": jnp.asarray(1 + draw(rng, (hd,), 0.2))}
    return jp, tt(jp)


@pytest.mark.parametrize("bias,norm", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_attn_params_and_projection_allclose_jax(bias, norm):
    jp, tp = attn_pair(32, 4, 2, 8, bias, norm)
    mine = A.attn_params(torch.Generator().manual_seed(0), 32, 4, 2, 8,
                         qkv_bias=bias, qk_norm=norm)
    assert shapes(mine) == shapes(jp)
    x = draw(np.random.default_rng(5), (2, 6, 32))
    want = JA._project_qkv(jp, jnp.asarray(x), 4, 2, 8)
    got = A._project_qkv(tp, torch.from_numpy(x), 4, 2, 8)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


def qkv(rng, b, s, h, hkv, hd, vd=None):
    return (draw(rng, (b, s, h, hd)), draw(rng, (b, s, hkv, hd)),
            draw(rng, (b, s, hkv, vd or hd)))


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("mask", ["none", "causal", "window"])
@pytest.mark.parametrize("cap", [None, 5.0])
def test_sdpa_allclose_jax(hkv, mask, cap):
    """GQA grouping: query head h reads kv head h // group."""
    rng = np.random.default_rng(6)
    q, k, v = qkv(rng, 2, 12, 4, hkv, 8)
    win = 5 if mask == "window" else None
    jm = None if mask == "none" else JA.causal_mask(12, 12, win)
    tm = None if mask == "none" else A.causal_mask(12, 12, win)
    want = JA._sdpa(*map(jnp.asarray, (q, k, v)), jm, logit_cap=cap)
    got = A._sdpa(*map(torch.from_numpy, (q, k, v)), tm, logit_cap=cap)
    close(got, want)


def test_sdpa_groups_query_heads_as_the_reference():
    """Each query head attends with kv head ``h // group``: with the other
    kv heads' values zeroed, only that group's outputs change."""
    rng = np.random.default_rng(7)
    q, k, v = qkv(rng, 1, 6, 4, 2, 8)
    v[:, :, 1] = 0.0
    out = A._sdpa(*map(torch.from_numpy, (q, k, v)), None).reshape(
        1, 6, 4, 8)
    assert bool((out[:, :, 2:] == 0).all())
    assert bool((out[:, :, :2].abs() > 0).any())


def test_causal_mask_equals_jax():
    for win in (None, 3):
        np.testing.assert_array_equal(A.causal_mask(7, 9, win).numpy(),
                                      np.asarray(JA.causal_mask(7, 9, win)))


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_mea_allclose_sdpa(window, hkv):
    """The chunked online softmax against the port's and the reference's
    dense attention, and against the reference's chunked one."""
    rng = np.random.default_rng(0)
    q, k, v = qkv(rng, 2, 256, 4, hkv, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = A._mea(tq, tk, tv, causal=True, window=window, q_chunk=64,
                 k_chunk=64)
    close(got, A._sdpa(tq, tk, tv, A.causal_mask(256, 256, window)),
          MEA_TOL)
    close(got, JA._sdpa(jq, jk, jv, JA.causal_mask(256, 256, window)),
          MEA_TOL)
    close(got, JA._mea(jq, jk, jv, causal=True, window=window, q_chunk=64,
                       k_chunk=64), LAYER_TOL)


def test_mea_non_causal_and_logit_cap_allclose_sdpa():
    rng = np.random.default_rng(1)
    q, k, v = map(torch.from_numpy, qkv(rng, 1, 128, 2, 2, 8))
    close(A._mea(q, k, v, causal=False, window=None, q_chunk=32,
                 k_chunk=32), A._sdpa(q, k, v, None), MEA_TOL)
    q = q * 8
    close(A._mea(q, k, v, causal=True, window=None, logit_cap=3.0,
                 q_chunk=32, k_chunk=64),
          A._sdpa(q, k, v, A.causal_mask(128, 128), logit_cap=3.0), MEA_TOL)


def test_mea_value_dim_other_than_the_head_dim():
    """MLA's form: v_dim != head_dim, against the reference's dense form
    with value dim vd (``tests/test_attention.py::test_mixed_value_dim``)."""
    rng = np.random.default_rng(2)
    b, s, h, hd, vd = 1, 128, 2, 24, 16
    q, k, v = qkv(rng, b, s, h, h, hd, vd)
    got = A._mea(*map(torch.from_numpy, (q, k, v)), causal=True,
                 window=None, q_chunk=32, k_chunk=32)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    w = jax.nn.softmax(jnp.where(JA.causal_mask(s, s)[0], scores, -1e30),
                       -1)
    want = jnp.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, h * vd)
    close(got, want, MEA_TOL)


def test_mea_rejects_a_ragged_sequence():
    x = torch.zeros(1, 100, 2, 8)
    with pytest.raises(ValueError, match="multiples"):
        A._mea(x, x, x, causal=True, window=None, q_chunk=64, k_chunk=64)


@pytest.mark.parametrize("window,hkv", [(None, 2), (512, 1), (None, 1)])
def test_attention_at_2048_takes_the_mea_branch(window, hkv, monkeypatch):
    """At S = 2,048 (>= MEA_MIN_SEQ, a multiple of MEA_Q_CHUNK) both sides
    take the chunked branch: B 1, 2 heads of 8, d 16."""
    jp, tp = attn_pair(16, 2, hkv, 8, bias=True, seed=3)
    x = draw(np.random.default_rng(8), (1, 2048, 16))
    pos = np.broadcast_to(np.arange(2048)[None], (1, 2048))
    calls = []
    mea = A._mea
    monkeypatch.setattr(A, "_mea", lambda *a, **k: calls.append(1)
                        or mea(*a, **k))
    got = A.attention(tp, torch.from_numpy(x), num_heads=2,
                      num_kv_heads=hkv, head_dim=8,
                      positions=torch.from_numpy(pos.copy()), window=window)
    want = JA.attention(jp, jnp.asarray(x), num_heads=2, num_kv_heads=hkv,
                        head_dim=8, positions=jnp.asarray(pos),
                        window=window)
    assert calls == [1]
    close(got, want)


@pytest.mark.parametrize("window,causal", [(None, True), (5, True),
                                           (None, False)])
def test_attention_allclose_jax(window, causal):
    jp, tp = attn_pair(32, 4, 2, 8, bias=True, norm=True, seed=4)
    x = draw(np.random.default_rng(9), (2, 24, 32))
    pos = np.random.default_rng(10).integers(0, 100, (2, 24))
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8, rope_base=1e6,
              window=window, causal=causal)
    close(A.attention(tp, torch.from_numpy(x),
                      positions=torch.from_numpy(pos), **kw),
          JA.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos), **kw))


def test_attention_m_rope_allclose_jax():
    jp, tp = attn_pair(32, 4, 4, 16, seed=5)
    x = draw(np.random.default_rng(11), (1, 10, 32))
    pos3 = np.random.default_rng(12).integers(0, 50, (1, 10, 3))
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=16, m_rope=True)
    close(A.attention(tp, torch.from_numpy(x),
                      positions=torch.from_numpy(pos3), **kw),
          JA.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos3),
                       **kw))


def decode_all(fn, tp, x, cache, steps, **kw):
    """The port's decode of ``x``'s first ``steps`` tokens."""
    b = x.shape[0]
    outs = []
    for t in range(steps):
        o, cache = fn(tp, torch.from_numpy(x[:, t:t + 1]), cache,
                      torch.full((b,), t), **kw)
        outs.append(o)
    return torch.cat(outs, 1), cache


def test_attention_decode_token_by_token_allclose_jax():
    """Each step's output and cache against JAX's decode (a cache of the
    whole sequence, qk-norm and the QKV bias), and the outputs together
    against the full-sequence attention."""
    b, s, h, hkv, hd, d = 2, 12, 4, 2, 8, 32
    jp, tp = attn_pair(d, h, hkv, hd, bias=True, norm=True, seed=6)
    x = draw(np.random.default_rng(13), (b, s, d))
    kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd)
    jc = {"k": jnp.zeros((b, s, hkv, hd)), "v": jnp.zeros((b, s, hkv, hd))}
    tc = {"k": torch.zeros(b, s, hkv, hd), "v": torch.zeros(b, s, hkv, hd)}
    store = tc["k"].data_ptr()
    for t in range(s):
        jo, jc = JA.attention_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                     jnp.full((b,), t, jnp.int32), **kw)
        to, tc = A.attention_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                    torch.full((b,), t), **kw)
        close(to, jo)
        for key in ("k", "v"):
            close(tc[key], jc[key])
    assert tc["k"].data_ptr() == store          # written in place
    full = A.attention(tp, torch.from_numpy(x), positions=torch.arange(s)
                       .expand(b, s), **kw)
    got, _ = decode_all(A.attention_decode, tp, x, {
        "k": torch.zeros(b, s, hkv, hd), "v": torch.zeros(b, s, hkv, hd)},
        s, **kw)
    close(got, full)


def test_attention_decode_at_ragged_positions_allclose_jax():
    """Rows of one batch at different positions write and read their own
    rows."""
    b, s, h, hkv, hd, d = 3, 10, 2, 1, 8, 16
    jp, tp = attn_pair(d, h, hkv, hd, seed=7)
    rng = np.random.default_rng(14)
    jc = {"k": jnp.asarray(draw(rng, (b, s, hkv, hd))),
          "v": jnp.asarray(draw(rng, (b, s, hkv, hd)))}
    tc = {k: tt(v) for k, v in jc.items()}
    x = draw(rng, (b, 1, d))
    pos = np.array([0, 4, 9])
    jo, jc = JA.attention_decode(jp, jnp.asarray(x), jc, jnp.asarray(pos),
                                 num_heads=h, num_kv_heads=hkv, head_dim=hd)
    to, tc = A.attention_decode(tp, torch.from_numpy(x), tc,
                                torch.from_numpy(pos), num_heads=h,
                                num_kv_heads=hkv, head_dim=hd)
    close(to, jo)
    close(tc["k"], jc["k"])


def windowed_case(seed=8):
    """One head group, window 4, 10 tokens: the reference's windowed
    attention over the whole sequence, the JAX parameters and inputs."""
    b, s, h, hkv, hd, d, win = 1, 10, 2, 1, 8, 16, 4
    jp, tp = attn_pair(d, h, hkv, hd, seed=seed)
    x = draw(np.random.default_rng(15), (b, s, d))
    kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd)
    full = JA.attention(jp, jnp.asarray(x), positions=jnp.asarray(
        np.arange(s)[None]), window=win, **kw)
    return jp, tp, x, kw, win, full


@pytest.mark.parametrize("rows", [4, 6, 10])
def test_ring_buffer_decode_past_the_window_equals_windowed_attention(rows):
    """A cache of ``rows`` >= window rows (the window's own size as
    ``_block_cache`` makes it, a larger ring, the whole sequence), decoded
    past the window: every position equals the reference's
    ``attention(..., window)`` over the whole sequence."""
    jp, tp, x, kw, win, full = windowed_case()
    b, s, _ = x.shape
    hkv, hd = kw["num_kv_heads"], kw["head_dim"]
    cache = {"k": torch.zeros(b, rows, hkv, hd),
             "v": torch.zeros(b, rows, hkv, hd)}
    got, _ = decode_all(A.attention_decode, tp, x, cache, s, window=win,
                        **kw)
    close(got, full)


def test_reference_window_sized_cache_differs_past_the_window():
    """The reference's fault, recorded: its window-sized cache (4 rows)
    matches its windowed attention at positions 0-3, and past them its
    clamped write overwrites the last row, so it is off by far more than
    the gate (0.99-1.73 in this case)."""
    jp, _, x, kw, win, full = windowed_case()
    b, s, _ = x.shape
    cache = {"k": jnp.zeros((b, win, 1, 8)), "v": jnp.zeros((b, win, 1, 8))}
    outs = []
    for t in range(s):
        o, cache = JA.attention_decode(jp, jnp.asarray(x[:, t:t + 1]), cache,
                                       jnp.full((b,), t, jnp.int32),
                                       window=win, **kw)
        outs.append(np.asarray(o))
    got, want = np.concatenate(outs, 1), np.asarray(full)
    np.testing.assert_allclose(got[:, :win], want[:, :win], **LAYER_TOL)
    err = np.abs(got[:, win:] - want[:, win:]).max(axis=(0, 2))
    assert (err > 0.5).all(), err


def test_ring_valid_is_the_references_prefix_before_the_ring_turns():
    pos = torch.arange(8)
    np.testing.assert_array_equal(
        A.ring_valid(8, pos).numpy(),
        (np.arange(8)[None, :] <= np.arange(8)[:, None]))
    # after the turn: rows hold positions 8, 9, 6, 7 at pos 9, window 3
    np.testing.assert_array_equal(
        A.ring_valid(4, torch.tensor([9]), 3).numpy(),
        [[True, True, False, True]])


@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_allclose_jax(cached):
    jp, tp = attn_pair(32, 4, 4, 8, seed=9)
    rng = np.random.default_rng(16)
    x, enc = draw(rng, (2, 5, 32)), draw(rng, (2, 7, 32))
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=8)
    jkv = JA.cross_kv_cache(jp, jnp.asarray(enc), num_kv_heads=4,
                            head_dim=8)
    tkv = A.cross_kv_cache(tp, torch.from_numpy(enc), num_kv_heads=4,
                           head_dim=8)
    for key in ("k", "v"):
        close(tkv[key], jkv[key])
    want = JA.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc),
                              cached_kv=jkv if cached else None, **kw)
    got = A.cross_attention(tp, torch.from_numpy(x),
                            None if cached else torch.from_numpy(enc),
                            cached_kv=tkv if cached else None, **kw)
    close(got, want)


# ---------------------------------------------------------------------- #
# MLA
# ---------------------------------------------------------------------- #
MLA = dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
           v_head_dim=8)


def mla_pair(d=32, h=2, seed=1):
    jp = JA.mla_params(jax.random.PRNGKey(seed), d, h, **MLA)
    jp["kv_norm"] = {"scale": jnp.asarray(
        1 + draw(np.random.default_rng(seed), (16,), 0.2))}
    assert shapes(A.mla_params(torch.Generator().manual_seed(0), d, h,
                               **MLA)) == shapes(jp)
    return jp, tt(jp)


def test_mla_expand_allclose_jax():
    jp, tp = mla_pair()
    c = draw(np.random.default_rng(17), (2, 5, 16))
    for g, w in zip(A._mla_expand(tp, torch.from_numpy(c), 2, 8, 8),
                    JA._mla_expand(jp, jnp.asarray(c), 2, 8, 8)):
        close(g, w)


@pytest.mark.parametrize("s,causal", [(10, True), (10, False),
                                      (2048, True)])
def test_mla_attention_allclose_jax(s, causal):
    """Both branches: the dense scores below MEA_MIN_SEQ, the concatenated
    form through _mea at S = 2,048."""
    jp, tp = mla_pair()
    x = draw(np.random.default_rng(18), (1, s, 32))
    pos = np.arange(s)[None]
    kw = dict(num_heads=2, causal=causal, **MLA)
    close(A.mla_attention(tp, torch.from_numpy(x),
                          positions=torch.from_numpy(pos), **kw),
          JA.mla_attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                           **kw))


def test_mla_decode_token_by_token_allclose_jax():
    b, s = 2, 10
    jp, tp = mla_pair(seed=2)
    x = draw(np.random.default_rng(19), (b, s, 32))
    kw = dict(num_heads=2, **MLA)
    jc = {"c_kv": jnp.zeros((b, s, 16)), "k_rope": jnp.zeros((b, s, 4))}
    tc = {"c_kv": torch.zeros(b, s, 16), "k_rope": torch.zeros(b, s, 4)}
    for t in range(s):
        jo, jc = JA.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                               jnp.full((b,), t, jnp.int32), **kw)
        to, tc = A.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                              torch.full((b,), t), **kw)
        close(to, jo)
        for key in ("c_kv", "k_rope"):
            close(tc[key], jc[key])
    got, _ = decode_all(A.mla_decode, tp, x, {
        "c_kv": torch.zeros(b, s, 16), "k_rope": torch.zeros(b, s, 4)}, s,
        **kw)
    close(got, A.mla_attention(tp, torch.from_numpy(x),
                               positions=torch.arange(s).expand(b, s), **kw))


# ---------------------------------------------------------------------- #
# RG-LRU
# ---------------------------------------------------------------------- #
def rglru_pair(d=32, w=24, cw=4, seed=0):
    jp = JR.rglru_params(jax.random.PRNGKey(seed), d, w, conv_width=cw)
    mine = R.rglru_params(torch.Generator().manual_seed(0), d, w,
                          conv_width=cw)
    assert shapes(mine) == shapes(jp)
    close(mine["log_lambda"], jp["log_lambda"], dict(rtol=1e-6, atol=0))
    return jp, tt(jp)


def test_rglru_gates_allclose_jax():
    jp, tp = rglru_pair()
    xw = draw(np.random.default_rng(20), (2, 6, 24))
    for g, w in zip(R._rglru_gates(tp, torch.from_numpy(xw)),
                    JR._rglru_gates(jp, jnp.asarray(xw))):
        close(g, w)


@pytest.mark.parametrize("cw", [4, 2])
def test_rglru_apply_allclose_jax(cw):
    jp, tp = rglru_pair(cw=cw)
    x = draw(np.random.default_rng(21), (2, 33, 32))
    close(R.rglru_apply(tp, torch.from_numpy(x)),
          JR.rglru_apply(jp, jnp.asarray(x)))


def test_rglru_apply_bf16_within_the_references_bf16_error():
    """bf16 weights and input on both sides (the scan fp32 inside): the
    port within the reference's own |bf16 - fp32| error."""
    jp, tp = rglru_pair(seed=1)
    x = draw(np.random.default_rng(22), (2, 17, 32))
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    want = JR.rglru_apply(jb, jnp.asarray(x, jnp.bfloat16))
    want32 = np.asarray(JR.rglru_apply(jp, jnp.asarray(x)))
    got = R.rglru_apply(tb, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    atol = float(np.abs(want - want32).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=atol)


def test_rglru_decode_token_by_token_allclose_jax():
    """Each step's output and state against JAX's, and the outputs
    together against the port's full-sequence scan."""
    jp, tp = rglru_pair(seed=2)
    b, s = 2, 9
    x = draw(np.random.default_rng(23), (b, s, 32))
    js = JR.rglru_init_state(b, 24, 4)
    ts = R.rglru_init_state(b, 24, 4)
    assert shapes(ts) == shapes(js)
    assert ts["h"].dtype == torch.float32
    outs = []
    for t in range(s):
        jo, js = JR.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = R.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), ts)
        close(to, jo)
        for key in ("h", "conv"):
            close(ts[key], js[key])
        outs.append(to)
    close(torch.cat(outs, 1), R.rglru_apply(tp, torch.from_numpy(x)))


def test_rglru_init_state_stacks_and_types():
    st = R.rglru_init_state(3, 8, 4, lead=(5,), dtype=torch.bfloat16)
    assert st["h"].shape == (5, 3, 8) and st["h"].dtype == torch.float32
    assert st["conv"].shape == (5, 3, 3, 8)
    assert st["conv"].dtype == torch.bfloat16
    assert not st["h"].any() and not st["conv"].any()


def test_lru_scan_is_the_recurrence():
    rng = np.random.default_rng(24)
    a, v = (torch.from_numpy(draw(rng, (2, 7, 3))) for _ in range(2))
    h, want = torch.zeros(2, 3), []
    for t in range(7):
        h = a[:, t] * h + v[:, t]
        want.append(h)
    assert torch.equal(R.lru_scan(a, v), torch.stack(want, 1))
