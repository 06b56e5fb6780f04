"""The port's chunked WKV (``repro_torch.kernels``: ``wkv_chunk``,
``ops.wkv_chunked_op``, ``ref.wkv_chunk_ref``) against the JAX package's,
on the CPU.

On the CPU the port's ``wkv_chunked`` runs its plain chunked version; the
JAX side runs the Pallas kernel in interpret mode through
``repro.kernels.ops.wkv_chunked_op`` and the sequential oracle
``repro.kernels.ref.wkv_chunk_ref``. The CUDA kernel itself is held
against the same plain versions on the card by ``chip_smoke.py``. The
gradient — ``wkv_chunked_backward``, on the CPU autograd through the
port's sequential recurrence — is held against ``jax.vjp`` of the
reference's op and of its oracle, and its chunked form (what the CUDA
kernel computes, ``wkv_chunked_backward_chunked_plain``) against the
sequential one in fp64 and against ``jax.vjp`` of the oracle in fp32.

Tolerances are the reference's own gate for the kernel against its
oracle: ``rtol=atol=1e-4`` at ``WKV_SHAPES`` (``tests/test_kernels.py``)
and ``2e-4`` in the property test; for gradients its gate for the chunked
forms, ``rtol=5e-3, atol=1e-4`` (``tests/test_perf_variants.py``). Inputs are drawn with numpy as the
reference's tests draw them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import recurrent as JR
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.wkv_chunk import (
    wkv_chunked, wkv_chunked_backward, wkv_chunked_backward_chunked_plain,
    wkv_chunked_backward_plain, wkv_chunked_plain, wkv_chunked_states,
)
from repro_torch.nn import recurrent as R

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's WKV_SHAPES: (BH, S, hd, chunk)
WKV_SHAPES = [(8, 64, 16, 16), (16, 128, 32, 32), (3, 50, 8, 16),
              (8, 64, 64, 64)]


def draw(bh, s, hd, seed, scale=0.5, decay_sd=0.3):
    """r, k, v, log_decay, u as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    r, k, v = (np.asarray(rng.normal(size=(bh, s, hd)) * scale, np.float32)
               for _ in range(3))
    lw = np.asarray(-np.exp(rng.normal(size=(bh, s, hd)) * decay_sd - 3),
                    np.float32)
    u = np.asarray(rng.normal(size=(bh, hd)) * 0.1, np.float32)
    return r, k, v, lw, u


@functools.lru_cache(maxsize=None)
def jax_results(bh, s, hd, chunk):
    """(inputs, the JAX op's output, the JAX oracle's output)."""
    x = draw(bh, s, hd, bh * s)
    j = [jnp.asarray(a) for a in x]
    return (x, np.asarray(jops.wkv_chunked_op(*j, chunk=chunk)),
            np.asarray(jref.wkv_chunk_ref(*j)))


PORT_FORMS = {
    "op": lambda x, chunk: ops.wkv_chunked_op(*x, chunk=chunk),
    "plain_chunked": lambda x, chunk: wkv_chunked_plain(*x, chunk=chunk),
    "sequential": lambda x, chunk: ref.wkv_chunk_ref(*x),
}


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
@pytest.mark.parametrize("bh,s,hd,chunk", WKV_SHAPES)
def test_wkv_forms_allclose_jax_kernel_and_oracle(form, bh, s, hd, chunk):
    x, j_op, j_ref = jax_results(bh, s, hd, chunk)
    got = PORT_FORMS[form]([torch.from_numpy(a) for a in x], chunk).numpy()
    assert got.shape == (bh, s, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, j_op, **TOL)
    np.testing.assert_allclose(got, j_ref, **TOL)


@settings(max_examples=8, deadline=None)
@given(bh=st.integers(1, 12), s=st.integers(4, 80),
       hd=st.sampled_from([8, 16]), seed=st.integers(0, 50))
def test_property_wkv_op_matches_jax_oracle(bh, s, hd, seed):
    x = draw(bh, s, hd, seed, scale=0.3, decay_sd=0.2)
    got = ops.wkv_chunked_op(*(torch.from_numpy(a) for a in x), chunk=16)
    want = jref.wkv_chunk_ref(*(jnp.asarray(a) for a in x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("bh,s,hd,chunk", [
    (3, 50, 16, 16),     # S ragged, BH not a multiple of 8
    (1, 17, 8, 16),      # one row, one full chunk and a 1-step tail
    (9, 5, 8, 16),       # S shorter than one chunk
    (5, 64, 32, 8),      # S a multiple of the chunk, BH ragged
])
def test_unpadded_op_equals_padded_reference(bh, s, hd, chunk):
    """The reference pads BH to 8 and S to the chunk with zeros and slices;
    the port runs a short last chunk instead. The real rows agree with
    the JAX op, and with the port's own op on the zero-padded inputs."""
    x = draw(bh, s, hd, 7 * bh + s)
    t = [torch.from_numpy(a) for a in x]
    got = ops.wkv_chunked_op(*t, chunk=chunk)
    want = jops.wkv_chunked_op(*(jnp.asarray(a) for a in x), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bh_p, s_p = -(-bh // 8) * 8, -(-s // chunk) * chunk

    def pad(a):
        return torch.nn.functional.pad(
            a, (0, 0, 0, s_p - s, 0, bh_p - bh) if a.dim() == 3
            else (0, 0, 0, bh_p - bh))
    padded = ops.wkv_chunked_op(*(pad(a) for a in t), chunk=chunk)
    torch.testing.assert_close(got, padded[:bh, :s], rtol=1e-6, atol=1e-6)


def test_empty_sequence_gives_empty_output():
    x = [torch.from_numpy(a) for a in draw(2, 0, 8, 0)]
    for out in (ops.wkv_chunked_op(*x, chunk=8), ref.wkv_chunk_ref(*x)):
        assert out.shape == (2, 0, 8)


# ragged S, hd < 64, BH not a multiple of 8; the last at the model's hd
GRAD_SHAPES = [(3, 50, 16, 16), (5, 37, 8, 16), (9, 20, 32, 8),
               (2, 40, 64, 64)]


def jax_vjp(fn, x, g):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in x))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("against", ["op", "oracle"])
@pytest.mark.parametrize("bh,s,hd,chunk", GRAD_SHAPES)
def test_op_gradient_allclose_jax_vjp(bh, s, hd, chunk, against):
    """The gradient of ``wkv_chunked_op`` in all five inputs against
    ``jax.vjp`` of the reference's op (its Pallas kernel in interpret mode
    forward, the oracle's VJP backward) and of the oracle itself, within
    the reference's gradient gate (``tests/test_perf_variants.py``:
    ``rtol=5e-3, atol=1e-4``)."""
    x = draw(bh, s, hd, 11 * bh + s)
    g = np.asarray(np.random.default_rng(s).normal(size=(bh, s, hd)),
                   np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in x]
    got = torch.autograd.grad(ops.wkv_chunked_op(*t, chunk=chunk), t,
                              torch.from_numpy(g))
    fn = (functools.partial(jops.wkv_chunked_op, chunk=chunk)
          if against == "op" else jref.wkv_chunk_ref)
    want = jax_vjp(fn, x, g)
    for name, a, b in zip(("r", "k", "v", "log_decay", "u"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_backward_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x = [torch.from_numpy(a) for a in draw(3, 21, 8, 5)]
    g = torch.from_numpy(draw(3, 21, 8, 6)[0])
    before = KERNELS["wkv_chunked_backward"].launches
    got = wkv_chunked_backward(*x, g)
    assert KERNELS["wkv_chunked_backward"].launches == before
    want = wkv_chunked_backward_plain(*x, g)
    assert len(got) == 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[4].shape == (3, 8) and got[3].shape == (3, 21, 8)


def test_plain_backward_in_fp64_keeps_fp64():
    """``chip_smoke.py`` takes the plain gradient in fp64 from fp32 inputs
    as the yardstick of the kernel's: the oracle runs in the inputs' type
    when it is wider than fp32, and agrees with the fp32 gradient."""
    x = [torch.from_numpy(a) for a in draw(2, 30, 8, 7)]
    g = torch.from_numpy(draw(2, 30, 8, 8)[0])
    g64 = wkv_chunked_backward_plain(*(t.double() for t in x), g.double())
    g32 = wkv_chunked_backward_plain(*x, g)
    for a, b in zip(g64, g32):
        assert a.dtype == torch.float64 and b.dtype == torch.float32
        torch.testing.assert_close(b.double(), a, rtol=1e-4, atol=1e-5)


def test_backward_of_an_empty_sequence_is_zero():
    x = [torch.from_numpy(a) for a in draw(2, 0, 8, 0)]
    grads = wkv_chunked_backward(*x, torch.zeros(2, 0, 8))
    assert [tuple(t.shape) for t in grads] == [(2, 0, 8)] * 4 + [(2, 8)]
    assert not grads[4].any()


def test_time_mix_bonus_gradient_sums_over_the_batch():
    """``u`` is one (H, hd) parameter broadcast over the batch before the
    WKV (expand, then reshape to (B·H, hd)), so its gradient is the sum of
    the per-row ``du`` over the batch: the kernel mode's time-mix
    gradients against the JAX sequential time mix's, B = 3."""
    jp = JR.rwkv_params(jax.random.PRNGKey(1), 32, 8)
    tp = {k: (torch.from_numpy(np.asarray(v).copy()) if k != "ln_x" else
              {"scale": torch.from_numpy(np.asarray(v["scale"]).copy())})
          for k, v in jp.items()}
    xin = np.asarray(np.random.default_rng(2).normal(size=(3, 24, 32)),
                     np.float32)
    want = jax.grad(lambda p: JR.rwkv_apply(p, jnp.asarray(xin), 8).sum())(jp)
    live = {k: (v.requires_grad_() if k != "ln_x" else
                {"scale": v["scale"].requires_grad_()})
            for k, v in tp.items()}
    out = R.rwkv_apply_kernel(live, torch.from_numpy(xin), 8, chunk=8)
    names = sorted(k for k in live if k != "ln_x")
    got = torch.autograd.grad(out.sum(), [live[k] for k in names])
    for name, a in zip(names, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(want[name]),
                                   rtol=5e-3, atol=1e-4, err_msg=name)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = [torch.from_numpy(a) for a in draw(3, 20, 8, 2)]
    before = KERNELS["wkv_chunked"].launches
    got = wkv_chunked(*x, chunk=8)
    assert KERNELS["wkv_chunked"].launches == before
    assert torch.equal(got, wkv_chunked_plain(*x, chunk=8))


def test_chunked_equals_sequential_for_each_chunk_size():
    """The chunking is exact in real arithmetic: every chunk size gives
    the sequential recurrence within the reference's gate."""
    x = [torch.from_numpy(a) for a in draw(4, 48, 16, 3)]
    want = ref.wkv_chunk_ref(*x)
    for chunk in (1, 5, 16, 48, 64):
        torch.testing.assert_close(wkv_chunked_plain(*x, chunk=chunk), want,
                                   **TOL)


def test_tensors_neither_on_the_cpu_nor_on_the_card_raise():
    """Only CPU tensors take the plain version: tensors on another device,
    or spread over two, raise instead of falling back to it."""
    x = [torch.from_numpy(a) for a in draw(2, 16, 8, 2)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        wkv_chunked(*(t.to("meta") for t in x), chunk=8)
    with pytest.raises(ValueError, match="several devices"):
        wkv_chunked(*x[:4], x[4].to("meta"), chunk=8)
    with pytest.raises(ValueError, match="unsupported device meta"):
        wkv_chunked_backward(*(t.to("meta") for t in x + [x[0]]))


# the chunked gradient's shapes: GRAD_SHAPES, then S ragged against the
# chunk, S < chunk, S = 1, BH = 1 and hd = 30
CHUNKED_GRAD_SHAPES = GRAD_SHAPES + [(2, 45, 16, 32), (3, 10, 8, 16),
                                     (2, 1, 8, 16), (1, 33, 16, 16),
                                     (2, 37, 30, 16)]
GRAD_NAMES = ("r", "k", "v", "log_decay", "u")


def grad_inputs(bh, s, hd, seed):
    """The five inputs and an output cotangent, drawn with numpy."""
    x = draw(bh, s, hd, seed)
    g = np.asarray(np.random.default_rng(seed + 1).normal(size=(bh, s, hd)),
                   np.float32)
    return x, g


@pytest.mark.parametrize("bh,s,hd,chunk", CHUNKED_GRAD_SHAPES)
def test_chunked_plain_gradient_equals_sequential_in_fp64(bh, s, hd, chunk):
    """The chunked form of the gradient (what the CUDA kernel computes) is
    the sequential recurrence's VJP refactored: in fp64 all five outputs
    agree with autograd through the oracle within 1e-10 of each output's
    largest entry, and each is within its ``magnitudes=True`` sum of
    |terms|."""
    x, g = grad_inputs(bh, s, hd, 3 * bh + s)
    t = [torch.from_numpy(a).double() for a in x + (g,)]
    got = wkv_chunked_backward_chunked_plain(*t, chunk=chunk)
    want = wkv_chunked_backward_plain(*t)
    mag = wkv_chunked_backward_chunked_plain(*t, chunk=chunk,
                                             magnitudes=True)
    for name, a, b, m in zip(GRAD_NAMES, got, want, mag):
        assert a.dtype == torch.float64 and a.shape == b.shape
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-10 * scale, name
        assert bool((m >= b.abs() * (1 - 1e-12)).all()), name
        assert bool((m >= a.abs() * (1 - 1e-12)).all()), name


@pytest.mark.parametrize("bh,s,hd,chunk", GRAD_SHAPES)
def test_chunked_plain_gradient_allclose_jax_vjp_in_fp32(bh, s, hd, chunk):
    """In fp32 the chunked form is within the reference's gradient gate
    (``rtol=5e-3, atol=1e-4``) of ``jax.vjp`` of its oracle."""
    x, g = grad_inputs(bh, s, hd, 5 * bh + s)
    got = wkv_chunked_backward_chunked_plain(
        *(torch.from_numpy(a) for a in x + (g,)), chunk=chunk)
    want = jax_vjp(jref.wkv_chunk_ref, x, g)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_dlog_decay_reverse_cumsum_identity_equals_the_direct_form():
    """The chunked form takes dlw_t as Z + Σ_{s>t} r_s dr'_s − Σ_{s≥t}
    k_s dk'_s inside each chunk (dr', dk' without their bonus terms, Z
    = Σ_j G_out S_out at the chunk's end): in fp64 it equals the direct
    ``w_t Σ_j G_t[i, j] S_{t-1}[i, j]``, G_t = dL/dS_t, over a row of
    several chunks with a short last one."""
    bh, s, hd, chunk = 2, 41, 8, 16
    x, g = grad_inputs(bh, s, hd, 17)
    r, k, v, lw, u, g = (torch.from_numpy(a).double() for a in x + (g,))
    w = torch.exp(lw)
    states, st = [], torch.zeros(bh, hd, hd, dtype=torch.float64)
    for t in range(s):
        states.append(st)                                # S_{t-1}
        st = w[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None, :]
    direct = torch.zeros_like(lw)
    gt = torch.zeros(bh, hd, hd, dtype=torch.float64)   # G_t = dL/dS_t
    for t in range(s - 1, -1, -1):
        direct[:, t] = w[:, t] * (gt * states[t]).sum(-1)
        gt = w[:, t, :, None] * gt + r[:, t, :, None] * g[:, t, None, :]
    got = wkv_chunked_backward_chunked_plain(r, k, v, lw, u, g,
                                             chunk=chunk)[3]
    torch.testing.assert_close(got, direct, rtol=1e-10, atol=1e-12)


def test_cpu_op_keeps_no_states_and_its_gradient_is_the_plain_one():
    """On CPU tensors the autograd op saves its five inputs only (no
    kernel scratch) and its gradient is bitwise
    ``wkv_chunked_backward_plain``'s; ``wkv_chunked_states`` gives the
    plain output and no states, and the backward wrapper ignores
    ``chunk`` and ``states`` there."""
    x, g = grad_inputs(3, 21, 8, 23)
    t = [torch.from_numpy(a).requires_grad_() for a in x]
    out = ops.wkv_chunked_op(*t, chunk=8)
    assert len(out.grad_fn.saved_tensors) == 5
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    want = wkv_chunked_backward_plain(*(a.detach() for a in t),
                                      torch.from_numpy(g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = [a.detach() for a in t]
    kept, states = wkv_chunked_states(*plain, chunk=8)
    assert states is None
    assert torch.equal(kept, wkv_chunked_plain(*plain, chunk=8))
    again = wkv_chunked_backward(*plain, torch.from_numpy(g), chunk=4,
                                 states=None)
    for a, b in zip(again, want):
        assert torch.equal(a, b)
