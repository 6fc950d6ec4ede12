"""The SPMD HASFL step and the optimizers in the port against the
reference, on the CPU: the reference's own SPMD tests mirrored (the
every-I aggregation flags, grad_accum's equivalence, the optimizers on a
quadratic bowl), the optimizers' arithmetic step by step, and three steps
of the port's `make_hasfl_train_step` against the reference's from the
same weights (`repro_torch.convert.params_from_numpy`), fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.core.sfl import make_hasfl_train_step as r_step
from repro.models import build_model as r_build
from repro_torch.convert import params_from_numpy
from repro_torch.core.sfl import make_hasfl_train_step as t_step
from repro_torch.models import build_model as t_build
from repro_torch.training.optim import make_optimizer as t_optimizer
from repro_torch.utils.tree import tree_leaves

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(arch, dtype="float32", **cut):
    """The reference's and the port's `reduced` config of ``arch`` in
    ``dtype``, with the overrides ``cut``."""
    return [dataclasses.replace(C.reduced(C.get_config(arch), **cut),
                                dtype=dtype) for C in (RC, TC)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lm_batch(rng, vocab, shape):
    return {"tokens": torch.from_numpy(rng.integers(0, vocab, shape)),
            "labels": torch.from_numpy(rng.integers(0, vocab, shape))}


def test_spmd_step_aggregates_every_interval():
    _, cfg = _configs("smollm-135m", dtype="bfloat16", n_layers=4)
    init_state, train_step = t_step(
        t_build(cfg), n_clients=2, cut_reps=1, agg_interval=3,
        optimizer_name="sgd", lr=1e-2)
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    flags = []
    for _ in range(6):
        state, _ = train_step(state, _lm_batch(rng, cfg.vocab_size,
                                               (2, 2, 16)))
        leaf = tree_leaves(state["client"])[0]
        flags.append(bool(torch.allclose(leaf[0].float(), leaf[1].float())))
    assert flags == [False, False, True, False, False, True]


def test_spmd_grad_accum_equivalence():
    """grad_accum=2 gives the update of grad_accum=1 (the reference's
    tolerance for the bf16 model)."""
    _, cfg = _configs("smollm-135m", dtype="bfloat16", n_layers=2)
    model = t_build(cfg)
    batch = _lm_batch(np.random.default_rng(1), cfg.vocab_size, (2, 4, 16))
    outs = []
    for accum in (1, 2):
        init_state, train_step = t_step(
            model, n_clients=2, cut_reps=1, agg_interval=10,
            optimizer_name="sgd", lr=1e-2, grad_accum=accum, remat=False)
        state = init_state(torch.Generator().manual_seed(7), "cpu")
        state, _ = train_step(state, batch)
        outs.append(state)
    for a, b in zip(tree_leaves(outs[0]["client"]),
                    tree_leaves(outs[1]["client"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_reduce_loss(name):
    target = torch.tensor([1.0, -2.0, 3.0])
    opt = t_optimizer(name, lr=0.1)
    p = torch.zeros(3)
    state = opt.init(p)
    for t in range(200):
        g = 2 * (p - target)
        p, state = opt.update(g, state, p, t)
    assert float(((p - target) ** 2).sum()) < 1e-2, name


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizer_steps_match_the_reference(name):
    """Five steps of each optimizer (with weight decay) on a small tree:
    the reference's arithmetic, within fp32 rounding."""
    from repro.training.optim import make_optimizer as r_optimizer

    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    ro = r_optimizer(name, 0.05, weight_decay=0.01)
    to = t_optimizer(name, 0.05, weight_decay=0.01)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs, ts = ro.init(rp), to.init(tp)
    for t, g in enumerate(grads):
        rp, rs = ro.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp,
                           jnp.asarray(t))
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, t)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("opt,remat", [("sgd", False), ("adam", True)])
def test_spmd_step_matches_the_reference(opt, remat):
    """Three steps of the port's step against the reference's (fp32,
    qk-norm, GQA, grad_accum 2): client and server trees within 1e-4.
    lr is the step's default 3e-4: Adam moves every element by about lr
    whatever its gradient, so an element whose gradient sits at the
    rounding floor differs by up to lr between the two."""
    rcfg, tcfg = _configs("qwen3-1.7b", n_layers=4)
    kw = dict(n_clients=2, cut_reps=1, agg_interval=2, optimizer_name=opt,
              lr=3e-4, grad_accum=2)
    r_init, r_train = r_step(r_build(rcfg), remat=False, **kw)
    t_init, t_train = t_step(t_build(tcfg), remat=remat, **kw)
    rstate = r_init(jax.random.PRNGKey(0))
    client = params_from_numpy(_np(rstate["client"]), tcfg, "cpu")
    server = params_from_numpy(_np(rstate["server"]), tcfg, "cpu")
    opt_t = t_optimizer(opt, 3e-4)
    tstate = {"client": client, "server": server,
              "opt": opt_t.init({"client": client, "server": server}),
              "step": 0}
    rng = np.random.default_rng(0)
    r_jit = jax.jit(r_train)
    for _ in range(3):
        batch = _lm_batch(rng, rcfg.vocab_size, (2, 4, 16))
        rstate, rm = r_jit(rstate, {k: jnp.asarray(v.numpy())
                                    for k, v in batch.items()})
        tstate, tm = t_train(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   **LOSS_TOL)
    assert tstate["step"] == int(rstate["step"]) == 3
    for part in ("client", "server"):
        for a, b in zip(jax.tree_util.tree_leaves(rstate[part]),
                        tree_leaves(tstate[part])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
