"""The port's LM training (``repro_torch.nn.transformer.loss_fn``,
``launch.steps.make_train_step``, ``training.optimizer``'s in-place update,
``launch.train.train_lm``, ``data.TokenStream``) against the JAX package's,
on the CPU, at the reduced ``rwkv6-3b`` (``ArchConfig.reduced()``: 2
layers, d = 256, 4 heads of 64, vocabulary 512; chunk 8 so that the chunked
forms run at S = 16).

Both sides start from the JAX weights, handed over bit for bit through
``convert.lm_params_from_jax``, and train on the same ``TokenStream``
batches. On the CPU the port's ``"chunked_kernel"`` mode runs the WKV
kernel's plain version, and its gradient is autograd through the sequential
recurrence; the JAX side runs the Pallas kernel in interpret mode with its
``jax.vjp`` of the sequential oracle.

Tolerances are the reference's own for these forms
(``tests/test_perf_variants.py``): the loss within ``rel=1e-4``, every
gradient leaf within ``rtol=5e-3, atol=1e-4``. After three Adam steps the
losses agree within ``rtol=1e-4``, and each leaf's total update ``p_3 -
p_0`` and moments within ``1e-3`` of the reference's in relative L2 norm:
Adam moves an element by about ``lr`` a step whatever the size of its
gradient, so an element whose gradient lies below the fp32 noise of the
two summation orders may step the other way (one element of 131,072 in
``w_r`` does, by 4e-4), and no elementwise tolerance tighter than ``lr``
holds for every element; a wrong learning rate, moment or leaf would miss
the norm by orders of magnitude. Remat on and off, and the in-place and
dict-wide Adam, are ``==``.
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
from repro.data import TokenStream as JTokenStream
from repro.launch import train as j_train_cli
from repro.launch.steps import make_train_step as j_make_train_step
from repro.nn import transformer as JT
from repro.training.optimizer import adam as j_adam
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.nn import transformer as T
from repro_torch.training.optimizer import adam, sgd

MODES = ("sequential", "chunked", "chunked_kernel")
B, S = 2, 16
LR = 3e-3
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
STEP_REL_L2 = 1e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The reduced rwkv6-3b (chunk 8) on both sides, same fp32 weights."""
    jcfg = dataclasses.replace(j_get_arch("rwkv6-3b").reduced(),
                               rwkv_chunk=8)
    cfg = dataclasses.replace(get_arch("rwkv6-3b").reduced(), rwkv_chunk=8)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jp


def port_params(jp, cfg):
    return convert.lm_params_from_jax(np_tree(jp), cfg, device="cpu")


def batches(vocab, n, seed=0):
    stream = TokenStream(vocab, B, S, seed=seed)
    return [next(stream) for _ in range(n)]


def torch_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_token_stream_equals_reference(seed):
    mine, theirs = (TokenStream(512, 3, 10, seed=seed),
                    JTokenStream(512, 3, 10, seed=seed))
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == np.int32 and a[k].shape == (3, 10)
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("mode", MODES)
def test_loss_allclose_reference(models, mode):
    jcfg, cfg, jp = models
    raw = batches(cfg.vocab_size, 1)[0]
    jl, jaux = JT.loss_fn(jp, dataclasses.replace(jcfg, rwkv_mode=mode),
                          {k: jnp.asarray(v) for k, v in raw.items()})
    loss, aux = T.loss_fn(port_params(jp, cfg),
                          dataclasses.replace(cfg, rwkv_mode=mode),
                          torch_batch(raw))
    assert sorted(aux) == sorted(jaux) == ["moe_aux", "nll"]
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    assert float(aux["nll"]) == pytest.approx(float(jaux["nll"]), rel=1e-4)
    assert float(aux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_gradients_allclose_reference(models, mode):
    jcfg, cfg, jp = models
    raw = batches(cfg.vocab_size, 1)[0]
    jc = dataclasses.replace(jcfg, rwkv_mode=mode)
    jgrads = jax.grad(lambda p: JT.loss_fn(
        p, jc, {k: jnp.asarray(v) for k, v in raw.items()})[0])(jp)
    want = convert.flatten_tree(np_tree(jgrads))
    _, _, got = loss_and_grads(port_params(jp, cfg),
                               dataclasses.replace(cfg, rwkv_mode=mode),
                               torch_batch(raw))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("mode", ["sequential", "chunked_kernel"])
def test_three_train_steps_allclose_reference(models, mode):
    jcfg, cfg, jp = models
    jc = dataclasses.replace(jcfg, rwkv_mode=mode)
    tc = dataclasses.replace(cfg, rwkv_mode=mode)
    raws = batches(cfg.vocab_size, 3)
    jopt = j_adam(LR)
    jstep = jax.jit(j_make_train_step(jc, jopt))
    jparams, jstate, jlosses = jp, jopt.init(jp), []
    for raw in raws:
        jparams, jstate, m = jstep(jparams, jstate,
                                   {k: jnp.asarray(v) for k, v in raw.items()})
        jlosses.append(float(m["loss"]))
    opt = adam(LR)
    params = port_params(jp, cfg)
    state = opt.init(dict(T.leaves(params)))
    step = make_train_step(tc, opt)
    losses = []
    for raw in raws:
        out, state, m = step(params, state, torch_batch(raw))
        assert out is params and sorted(m) == ["loss", "moe_aux", "nll"]
        losses.append(float(m["loss"]))
    assert int(state.step) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    start = convert.flatten_tree(np_tree(jp))
    want = convert.flatten_tree(np_tree(jparams))
    for name, p in T.leaves(params):
        assert not p.requires_grad
        moved, jmoved = p.numpy() - start[name], want[name] - start[name]
        assert rel_l2(moved, jmoved) <= STEP_REL_L2, name
    for part in ("mu", "nu"):
        jm = convert.flatten_tree(np_tree(getattr(jstate, part)))
        for name, t in getattr(state, part).items():
            assert rel_l2(t.numpy(), jm[name]) <= STEP_REL_L2, (part, name)


def rel_l2(got, want) -> float:
    return float(np.linalg.norm((got - want).ravel())
                 / max(np.linalg.norm(want.ravel()), 1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_remat_equals_no_remat_bitwise(models, mode):
    """Each block recomputed in the backward (torch.utils.checkpoint) gives
    the bits of the stored forward: loss and every gradient."""
    _, cfg, jp = models
    raw = batches(cfg.vocab_size, 1, seed=3)[0]
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, rwkv_mode=mode, remat=remat)
        out[remat] = loss_and_grads(port_params(jp, cfg), c,
                                    torch_batch(raw))
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[True][2].items():
        assert torch.equal(g, out[False][2][name]), name


def test_remat_recomputes_each_block_in_the_backward(models, monkeypatch):
    """With remat the blocks run twice (forward, then recomputed in the
    backward); without it once, as in inference."""
    _, cfg, jp = models
    raw = batches(cfg.vocab_size, 1)[0]
    calls = []
    block = T.block_apply
    monkeypatch.setattr(T, "block_apply",
                        lambda *a: calls.append(1) or block(*a))
    for remat, want in ((True, 2 * cfg.num_layers), (False, cfg.num_layers)):
        calls.clear()
        loss_and_grads(port_params(jp, cfg),
                       dataclasses.replace(cfg, remat=remat),
                       torch_batch(raw))
        assert len(calls) == want


OPTIMIZERS = {
    "adam": lambda: adam(LR),
    "adamw_clipped": lambda: adam(LR, weight_decay=0.1, grad_clip_norm=0.5),
    "sgd_momentum": lambda: sgd(LR, momentum=0.9),
    "sgd": lambda: sgd(LR),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_in_place_update_equals_dict_wide_bitwise(name):
    """update_in_place (leaf by leaf, into the parameters and moments,
    emptying the gradient dict) == update + apply_updates, bit for bit,
    over three steps."""
    opt = OPTIMIZERS[name]()
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5, 7), "b": (11,), "c": (4, 4)}
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()}
    mine = {k: v.clone() for k, v in params.items()}
    state, my_state = opt.init(params), opt.init(mine)
    storage = {k: v.data_ptr() for k, v in mine.items()}
    for _ in range(3):
        grads = {k: torch.from_numpy(
            (rng.normal(size=s) * 10.0 ** rng.integers(-8, 1)).astype(
                np.float32)) for k, s in shapes.items()}
        updates, state = opt.update(grads, state, params)
        params = {k: p + updates[k] for k, p in params.items()}
        mine_grads = {k: g.clone() for k, g in grads.items()}
        my_state = opt.update_in_place(mine_grads, my_state, mine)
        assert mine_grads == {}
    assert int(my_state.step) == int(state.step) == 3
    for k in shapes:
        assert mine[k].data_ptr() == storage[k]
        assert torch.equal(mine[k], params[k]), k
        for part in ("mu", "nu"):
            if getattr(state, part) is not None:
                assert torch.equal(getattr(my_state, part)[k],
                                   getattr(state, part)[k]), (part, k)


def reference_cli_losses(monkeypatch, argv):
    """The step losses ``repro.launch.train`` prints for ``argv``."""
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    j_train_cli.main()
    monkeypatch.undo()
    return [float(x) for x in re.findall(r"loss=([-\d.]+)", out.getvalue())]


def test_cli_losses_allclose_reference(models, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch rwkv6-3b --steps 3
    --batch 2 --seq 16 --device cpu`` against ``repro.launch.train``'s
    same command. The port draws its weights from a torch generator, whose
    numbers are not JAX's, so here both start from the JAX weights of
    seed 0; the losses then agree within ``rtol=1e-4`` (the reference
    prints four decimals)."""
    argv = ["--arch", "rwkv6-3b", "--steps", "3", "--batch", "2", "--seq",
            "16"]
    want = reference_cli_losses(monkeypatch, argv)
    jcfg = j_get_arch("rwkv6-3b").reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = port_params(jp, get_arch("rwkv6-3b").reduced())
    monkeypatch.setattr(T, "init_params", lambda cfg, **kw: tp)
    losses = train_cli.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[train] rwkv6-3b-smoke: 1,644,800 params" in printed
    shown = [float(x) for x in re.findall(r"loss=([-\d.]+)", printed)]
    assert len(losses) == len(want) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(shown, np.round(losses, 4))
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=5e-5)


def test_cli_draws_its_own_weights_and_trains(capsys):
    """Without the JAX weights: the CLI's own seed-0 draw trains to finite
    losses near log(vocab) at the first step."""
    losses = train_cli.main(["--arch", "rwkv6-3b", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--device",
                             "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert abs(losses[0] - np.log(512)) < 1.0
    assert capsys.readouterr().out.count("loss=") == 2


@pytest.mark.parametrize("arch,item", [("whisper-large-v3", "item 7e"),
                                       ("qwen2-vl-7b", "item 7e"),
                                       ("arctic-480b", "item 7d")])
def test_cli_unported_lm_architectures_raise(arch, item):
    """The architectures that waited for ROADMAP Queue 1 ``item`` train
    now: one step of the CLI, a finite loss
    (``tests/test_torch_archs.py`` holds their losses against the
    reference CLI's)."""
    losses = train_cli.main(["--arch", arch, "--steps", "1", "--batch", "2",
                             "--seq", "8", "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses).all(), item
