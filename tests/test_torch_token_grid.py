"""Token cells in the port's grid runner (`repro_torch.api.run_grid`) on
the CPU.

The grid folds G cells of N clients into one ``[G·N, ...]`` carry; a token
model's folded forward runs every op whose plan may follow the leading
extent once per cell (the products, the embedding gather, the MoE and
mamba blocks, the cross-entropy; `utils.cells.by_cell`) and plans its
norms on one cell's rows.  So each cell must equal its own `run()`
bitwise, and match the reference's `run_grid` as a token `Session`
matches the reference's: decisions, clocks and gather plans bitwise,
losses and parameters within 1e-4 at fp32 and 1e-3 at bf16.

Grids: smollm-tiny in fp32 and at its registered bf16, and reduced dbrx
in fp32 (two experts of four a token), each over four cells in two pow2
buckets with crossed seeds (cells reading their own data) and other
cuts; every other token family that trains, reduced, on a two-cell grid.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.api import grid as TGRID
from repro_torch.api import run_grid
from repro_torch.api import runners as TRUN
from repro_torch.data.pipeline import DeviceClientStore
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import rmsnorm as TRN
from repro_torch.models import layers as TL
from repro_torch.utils import cells as TCELLS
from repro_torch.utils.tree import tree_leaves

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=1e-3, atol=1e-3)}
# (arch, type): smollm-tiny as registered, dbrx `reduced` (2 layers, 4
# experts top-2)
GRIDS = {"smollm_fp32": ("smollm-tiny", "float32"),
         "smollm_bf16": ("smollm-tiny", "bfloat16"),
         "dbrx_fp32": ("dbrx-132b", "float32")}
# two buckets (b_pad 4 and 8), seeds crossed in the b=4 bucket, two cuts
CELLS = [dict(policy="fixed(b=4,cut=1)", seed=0),
         dict(policy="fixed(b=4,cut=2)", seed=1),
         dict(policy="fixed(b=8,cut=1)", seed=1)]
# the families that train, beside smollm and dbrx above
FAMILIES = ["qwen3-1.7b", "glm4-9b", "phi3-mini-3.8b",
            "llama4-maverick-400b-a17b", "jamba-v0.1-52b", "internvl2-1b",
            "xlstm-350m"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _register(arch, dtype):
    name = f"{arch}-tgrid-{dtype}"
    for C in (RC, TC):
        cfg = C.get_config(arch)
        if arch != "smollm-tiny":
            cfg = C.reduced(cfg)
        C.register(dataclasses.replace(cfg, arch_id=name, dtype=dtype))
    return name


def _kw(name, cell, sfl_cls, **extra):
    kw = dict(arch=name, n_clients=4, partition="iid", n_train=128,
              n_test=16, seq_len=16, rounds=4, eval_every=2, estimate=False,
              sfl=sfl_cls(lr=0.05, agg_interval=2))
    kw.update(cell, **extra)
    return kw


def _record_plans(sim):
    plans = []
    draw = sim.store.segment_indices

    def recording(*a):
        plans.append(draw(*a))
        return plans[-1]

    sim.store.segment_indices = recording
    return plans


def _same_history(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))


def _assert_bitwise(r, s, sess_r, sess_s):
    assert r.rounds == s.rounds and r.clock == s.clock
    assert r.train_loss == s.train_loss
    assert r.test_loss == s.test_loss and r.test_acc == s.test_acc
    assert _same_history(r.b_history, s.b_history)
    assert _same_history(r.cut_history, s.cut_history)
    a, b = tree_leaves(sess_r.sim._stacked), tree_leaves(sess_s.sim._stacked)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _grid_against_run(specs):
    """Fresh sessions of ``specs`` through `run_grid` and one by one,
    checked bitwise cell by cell (gather plans too); returns the grid's
    results and dispatches."""
    alone = [TSession(s, device="cpu") for s in specs]
    plans_alone = [_record_plans(s.sim) for s in alone]
    seq = [s.run() for s in alone]
    folded = [TSession(s, device="cpu") for s in specs]
    plans_folded = [_record_plans(s.sim) for s in folded]
    TGRID.run_group.dispatches.clear()
    res = run_grid(folded)
    for r, s, sr, ss, pr, ps in zip(res, seq, folded, alone, plans_folded,
                                    plans_alone):
        _assert_bitwise(r, s, sr, ss)
        assert _same_history(pr, ps)
    return res, list(TGRID.run_group.dispatches)


@pytest.mark.parametrize("grid,impl", [
    ("smollm_fp32", None), ("smollm_fp32", "kernel"),
    ("smollm_bf16", "kernel"), ("dbrx_fp32", None)])
def test_token_grid_matches_own_runs_bitwise(grid, impl):
    name = _register(*GRIDS[grid])
    specs = [TSpec(**_kw(name, c, TC.SFLConfig, update_impl=impl))
             for c in CELLS + [dict(policy="hasfl", seed=0)]]
    res, dispatches = _grid_against_run(specs)
    # two buckets a segment; the b=4 bucket folds two seeds
    assert sorted({d.t0 for d in dispatches}) == [0, 2]
    assert any(len(d.members) == 2 for d in dispatches)
    assert len({tuple(r.train_loss) for r in res}) == len(res)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_token_grid_matches_reference_run_grid(grid):
    """The grid through the reference's `run_grid` and the port's, from
    the reference's initial units: decisions, clocks and gather plans
    bitwise; losses and parameters within 1e-4 (fp32) or 1e-3 (bf16: a
    weight moves by whole ulps where the frameworks round a product or a
    mean at another place, as in `test_torch_lm_train.py`)."""
    arch, dtype = GRIDS[grid]
    name = _register(arch, dtype)
    tol = TOL[dtype]
    refs = [RSession(RSpec(**_kw(name, c, RC.SFLConfig))) for c in CELLS]
    inits = [jax.tree_util.tree_map(np.asarray, r.sim.units) for r in refs]
    ref_plans = [_record_plans(r.sim) for r in refs]
    r_res = RSession.run_grid(refs)
    ports = [TSession(TSpec(**_kw(name, c, TC.SFLConfig)), device="cpu",
                      init_units=init) for c, init in zip(CELLS, inits)]
    port_plans = [_record_plans(p.sim) for p in ports]
    t_res = run_grid(ports)
    assert TGRID.run_group.dispatches
    for r, t, rs, ts, rp, tp in zip(r_res, t_res, refs, ports, ref_plans,
                                    port_plans):
        assert _same_history(t.b_history, r.b_history)
        assert _same_history(t.cut_history, r.cut_history)
        assert t.clock == r.clock and t.rounds == r.rounds
        assert _same_history(tp, rp)
        for f in ("train_loss", "test_loss"):
            np.testing.assert_allclose(getattr(t, f), getattr(r, f),
                                       err_msg=f, **tol)
        r_leaves = jax.tree_util.tree_leaves(rs.sim._stacked)
        t_leaves = tree_leaves(ts.sim._stacked)
        assert len(r_leaves) == len(t_leaves)
        for a, b in zip(t_leaves, r_leaves):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("runner", ["sequential", "auto"])
def test_token_runners_equal_run(runner):
    """``"sequential"`` runs each token cell alone; ``"auto"`` reads the
    table's token row (the grid on the CPU as on the card) and folds —
    both bitwise equal to `run()`."""
    name = _register("smollm-tiny", "float32")
    specs = [TSpec(**_kw(name, c, TC.SFLConfig)) for c in CELLS[:2]]
    alone = [TSession(s, device="cpu").run() for s in specs]
    TGRID.run_group.dispatches.clear()
    got = run_grid(specs, runner=runner, device="cpu")
    assert bool(TGRID.run_group.dispatches) == (runner == "auto")
    for r, s in zip(got, alone):
        assert r.clock == s.clock and r.train_loss == s.train_loss
        assert r.test_loss == s.test_loss
        assert _same_history(r.b_history, s.b_history)
    assert TRUN.pick(specs[0], "cpu").runner == "grid"
    assert TRUN.pick(specs[0], "cuda") == TRUN.ExecutionChoice(
        "grid", update_impl="kernel")


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_folds_bitwise(arch):
    """Each other token family that trains, reduced to fp32, on a two-cell
    grid of crossed seeds: every cell bitwise its own run."""
    name = _register(arch, "float32")
    specs = [TSpec(**_kw(name, dict(policy="fixed(b=4,cut=1)", seed=s),
                         TC.SFLConfig, rounds=2, eval_every=2))
             for s in (0, 1)]
    _, dispatches = _grid_against_run(specs)
    assert [len(d.members) for d in dispatches] == [2]


def test_one_cell_grid_is_its_run():
    name = _register("smollm-tiny", "bfloat16")
    _grid_against_run([TSpec(**_kw(name, CELLS[0], TC.SFLConfig))])


def test_token_stores_fold_and_stack():
    """A token store's ``[n_train, S]`` arrays lay end to end and a folded
    plan gathers each cell's own sequences."""
    def store(seed):
        r = np.random.default_rng(seed)
        return DeviceClientStore(
            {"tokens": r.integers(0, 50, (6, 5)).astype(np.int32),
             "labels": r.integers(0, 50, (6, 5)).astype(np.int32)},
            [np.arange(6)], r)

    a, b = store(0), store(1)
    stacked = DeviceClientStore.stack_arrays([a, b])
    assert stacked["tokens"].shape == (12, 5)
    plan, mask = DeviceClientStore.fold_plan(
        np.array([[[[1, 5]]], [[[0, 2]]]]), np.ones((2, 1, 2), np.float32),
        n_train=6)
    batch = DeviceClientStore.device_batch(
        stacked, torch.as_tensor(plan[0]), torch.as_tensor(mask))
    assert batch["tokens"].shape == (2, 2, 5)
    assert torch.equal(batch["tokens"][1], b.arrays["tokens"][[0, 2]])
    assert torch.equal(batch["labels"][0], a.arrays["labels"][[1, 5]])


@pytest.mark.parametrize("cell_size,calls", [(None, 1), (2, 3)])
def test_mm_runs_one_product_a_cell(cell_size, calls, monkeypatch):
    """`layers.mm` on client-stacked weights: one `torch.bmm` a cell where
    a cell size splits the leading axis, each cell's product that cell's
    own."""
    seen = []
    bmm = torch.bmm

    def counted(x, w):
        seen.append(w.shape[0])
        return bmm(x, w)

    monkeypatch.setattr(torch, "bmm", counted)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 3, 5, 8), generator=g)
    w = torch.randn((6, 8, 4), generator=g)
    got = TL.mm(x, w, cell_size)
    assert len(seen) == calls
    want = torch.cat([TL.mm(xc, wc) for xc, wc in zip(x.split(2),
                                                       w.split(2))])
    assert torch.equal(got, want)


def test_rmsnorm_plans_the_kernel_on_one_cell(monkeypatch):
    """On the card `kernels.ops.rmsnorm` hands the kernel the cell count,
    forward and (through `RMSNormFn`) backward, so its plan is one cell's;
    the card is faked (the dispatch says "card", the kernels record their
    arguments and return the plain version's numbers)."""
    seen = []

    def kernel(x, scale, eps=1e-5, cells=1):
        seen.append(("fwd", x.shape[0], cells))
        return TRN.rmsnorm_plain(x, scale, eps)

    def bwd(x, scale, dy, eps=1e-5, cells=1):
        seen.append(("bwd", x.shape[0], cells))
        return TRN.rmsnorm_bwd_plain(x, scale, dy, eps)

    monkeypatch.setattr(TOPS, "_on_card", lambda t: True)
    monkeypatch.setattr(TRN, "rmsnorm_kernel", kernel)
    monkeypatch.setattr(TRN, "rmsnorm_bwd_kernel", bwd)
    x = torch.randn((6, 2, 3, 8), requires_grad=True)
    scale = torch.ones((6, 8), requires_grad=True)
    TOPS.rmsnorm(x, scale, cell_size=2).sum().backward()
    with torch.no_grad():
        TOPS.rmsnorm(x, scale, cell_size=6)
    assert seen == [("fwd", 6, 3), ("bwd", 6, 3), ("fwd", 6, 1)]
    assert TRN._plan_rows(36, 3) == 12
    with pytest.raises(ValueError, match="fold"):
        TRN._plan_rows(36, 5)


def test_by_cell_sums_a_cells_gradients_as_its_own_run():
    """An op that uses its input three times, beside another use outside
    it: the gradient of a folded call equals the cells' own calls bitwise
    (unsplit, the op reads its input through one view, as a split part
    does, so the uses' sums associate alike); dict and None arguments
    split too, and a tuple result concatenates element by element."""
    g = torch.Generator().manual_seed(3)
    base = torch.randn((4, 64), generator=g, dtype=torch.float64).float()
    w = {"a": torch.randn((4, 64), generator=g), "skip": None}

    def op(x, p, none):
        assert none is None
        return (x * x * p["a"] + x).sin(), x.sum(dim=1)

    def grads(x, a, cell):
        x = x.detach().requires_grad_()
        out, tot = TCELLS.by_cell(op, cell, x, dict(w, a=a), None)
        (out.sum() + tot.sum() + (x * 3.0).sum()).backward()
        return out, x.grad

    out, gx = grads(base, w["a"], 2)
    parts = [grads(c, a, None) for c, a in zip(base.split(2),
                                                w["a"].split(2))]
    assert torch.equal(out, torch.cat([p[0] for p in parts]))
    assert torch.equal(gx, torch.cat([p[1] for p in parts]))
