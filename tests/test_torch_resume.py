"""Crash-safe checkpoint/resume in the port (DESIGN.md §12), on the CPU.

After `tests/test_resume.py`, on the narrowed VGG of
`test_torch_session.py` in place of ``smollm-tiny``: a `Session` run with
``checkpoint_every`` is bitwise the same spec run without it, and
`Session.resume` from any snapshot continues bitwise — decision stream,
clock floats, eval losses and final parameters.  Plus the storage layer
(`repro_torch.training.checkpoint`): atomic tmp-then-rename writes, the
json sidecar as commit marker, structured validation, and a snapshot
holding what the reference's holds for the same spec.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.training import checkpoint as rckpt
from repro_torch.api import ExperimentSpec, Session
from repro_torch.training import checkpoint as ckpt
from repro_torch.utils.tree import tree_leaves

ARCH = "vgg9-torch-resume"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for the whole module, the module-scoped `reference` run
    included (CPU GEMMs may sum in another order on more threads)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _register():
    for C in (RC, TC):
        base = C.get_config("vgg9-cifar-small")
        C.register(dataclasses.replace(
            base, arch_id=ARCH, conv_channels=(8, 16, 16), fc_dims=(32,),
            image_size=16))


def _kw(sfl_cls=TC.SFLConfig, **overrides):
    base = dict(
        arch=ARCH, n_clients=4, partition="iid", n_train=200, n_test=50,
        seed=0, policy="hasfl", estimate=True, scenario="churn-heavy",
        scenario_seed=7, rounds=6, eval_every=2, fault_mode="deadline",
        deadline_factor=2.0, sfl=sfl_cls(lr=0.05, agg_interval=2),
    )
    base.update(overrides)
    return base


def _spec(**overrides):
    _register()
    return ExperimentSpec(**_kw(**overrides))


def _final_params(sess):
    return [x.clone() for x in tree_leaves(sess.sim._stacked)]


def _assert_result_bitwise(a, b):
    assert a.rounds == b.rounds
    assert a.clock == b.clock                    # float lists, exact
    assert a.train_loss == b.train_loss
    assert a.test_loss == b.test_loss
    assert a.test_acc == b.test_acc
    assert len(a.b_history) == len(b.b_history)
    for x, y in zip(a.b_history, b.b_history):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.cut_history, b.cut_history):
        np.testing.assert_array_equal(x, y)


def _assert_params_bitwise(a, b):
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted run every checkpointed variant must reproduce:
    hasfl + online estimation + churn scenario + deadline faults, the
    maximal-state path (host RNG streams, controller estimator state and
    the fault-aware clock all have to survive the snapshot)."""
    sess = Session(_spec(), device="cpu")
    res = sess.run()
    return res, _final_params(sess)


def test_checkpointed_run_is_bitwise_neutral(tmp_path, reference):
    res_ref, params_ref = reference
    d = str(tmp_path / "snaps")
    sess = Session(_spec(checkpoint_every=2, checkpoint_dir=d), device="cpu")
    res = sess.run()
    _assert_result_bitwise(res, res_ref)
    _assert_params_bitwise(_final_params(sess), params_ref)
    # snapshots landed at every boundary, atomically (no stragglers)
    assert ckpt.latest_snapshot(d) == 6
    assert sorted(ckpt._complete_steps(d, "snap")) == [2, 4, 6]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


@pytest.mark.parametrize("step", [2, 4])
def test_kill_and_resume_is_bitwise(tmp_path, reference, step):
    """A crash after round ``step``: resume from its snapshot, and the
    continued run reproduces the uninterrupted one exactly."""
    res_ref, params_ref = reference
    d = str(tmp_path / "snaps")
    spec = _spec(checkpoint_every=2, checkpoint_dir=d)
    Session(spec, device="cpu").run()

    resumed = Session.resume(spec, step=step, device="cpu")
    assert resumed._resume["t"] == step
    res = resumed.run()
    _assert_result_bitwise(res, res_ref)
    _assert_params_bitwise(_final_params(resumed), params_ref)


def test_resume_copies_into_the_simulators_tensors(tmp_path):
    """The restore writes into the stacked tensors the simulator already
    holds (nothing that refers to them goes stale)."""
    d = str(tmp_path / "snaps")
    spec = _spec(checkpoint_every=2, checkpoint_dir=d)
    Session(spec, device="cpu").run()
    fresh = Session(spec, device="cpu")
    before = [x.data_ptr() for x in tree_leaves(fresh.sim._stacked)]
    arrays, meta = ckpt.load_snapshot(d, 4)
    fresh._restore_state(arrays, meta)
    leaves = tree_leaves(fresh.sim._stacked)
    assert [x.data_ptr() for x in leaves] == before
    for i, x in enumerate(leaves):
        np.testing.assert_array_equal(x.numpy(), arrays[f"param_leaf_{i}"])


def test_resume_refuses_mismatched_spec(tmp_path):
    d = str(tmp_path / "snaps")
    spec = _spec(checkpoint_every=2, checkpoint_dir=d)
    Session(spec, device="cpu").run()
    with pytest.raises(ValueError, match="different spec.*seed"):
        Session.resume(spec.replace(seed=1), device="cpu")
    # a moved snapshot dir is NOT a spec difference
    sess = Session.resume(spec.replace(checkpoint_dir=str(tmp_path / "x")),
                          checkpoint_dir=d, device="cpu")
    assert sess._resume is not None


def test_restore_refuses_another_parameter_structure(tmp_path):
    d = str(tmp_path / "snaps")
    spec = _spec(checkpoint_every=2, checkpoint_dir=d)
    Session(spec, device="cpu").run()
    arrays, meta = ckpt.load_snapshot(d, 2)
    meta["structure"][0][1] = [99]
    with pytest.raises(ValueError, match="parameter tree"):
        Session(spec, device="cpu")._restore_state(arrays, meta)


def test_resume_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Session.resume(_spec(), device="cpu")


def test_controller_state_roundtrips_through_snapshot(tmp_path):
    d = str(tmp_path / "snaps")
    spec = _spec(checkpoint_every=2, checkpoint_dir=d)
    sess = Session(spec, device="cpu")
    sess.run()
    st = sess.policy.state_dict()
    assert st["decisions"] > 0 and st["prev"] is not None
    _, meta = ckpt.load_snapshot(d)
    assert meta["controller"] == json.loads(json.dumps(st))
    fresh = Session(spec.replace(checkpoint_dir=None, checkpoint_every=0),
                    device="cpu")
    assert fresh.policy.state_dict() != st
    fresh.policy.load_state_dict(st)
    assert fresh.policy.state_dict() == st       # includes the RNG bit state


def test_snapshot_holds_the_references_fields(tmp_path):
    """The same spec snapshotted by the reference and by the port: the
    same named arrays, decisions, clocks, RNG streams and controller
    state; only the parameter-tree signature differs (``treedef``
    against the port's ``structure``)."""
    over = dict(estimate=False, rounds=4, checkpoint_every=2)
    rd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    _register()
    ref = RSession(RSpec(**_kw(RC.SFLConfig, checkpoint_dir=rd,
                                conv_impl="kernel", update_impl="kernel",
                                **over)))
    ref.run()
    Session(ExperimentSpec(**_kw(checkpoint_dir=td, **over)),
            device="cpu").run()
    r_arrays, r_meta = rckpt.load_snapshot(rd, 2)
    t_arrays, t_meta = ckpt.load_snapshot(td, 2)
    assert sorted(r_arrays) == sorted(t_arrays)
    for k in ("b", "cuts", "res_rounds", "res_clock", "res_b_history",
              "res_cut_history"):
        np.testing.assert_array_equal(t_arrays[k], r_arrays[k])
    for k, v in r_arrays.items():
        assert t_arrays[k].shape == v.shape, k
    assert set(r_meta) - {"treedef"} == set(t_meta) - {"structure"}
    for k in ("clock", "rng_sampler", "rng_sim", "controller", "step",
              "snapshot_version", "n_param_leaves"):
        assert t_meta[k] == r_meta[k], k


# ---------------------------------------------------------------------------
# Storage layer: atomicity, commit markers, structured validation
# ---------------------------------------------------------------------------


def test_latest_snapshot_skips_incomplete_writes(tmp_path):
    d = str(tmp_path)
    ckpt.save_snapshot(d, 1, {"a": np.arange(3)}, {"clock": 0.5})
    assert ckpt.latest_snapshot(d) == 1
    # npz without its json sidecar: crash between the two writes
    with open(os.path.join(d, "snap_2.npz"), "wb") as f:
        np.savez(f, a=np.arange(3))
    # json marker but a torn npz: crash mid-replace (or disk corruption)
    with open(os.path.join(d, "snap_3.npz"), "wb") as f:
        f.write(b"not a zipfile")
    with open(os.path.join(d, "snap_3.json"), "w") as f:
        json.dump({"snapshot_version": ckpt.SNAPSHOT_VERSION, "step": 3}, f)
    # a stale tmp from a crash mid-write
    with open(os.path.join(d, "snap_4.npz.tmp"), "wb") as f:
        f.write(b"partial")
    assert ckpt.latest_snapshot(d) == 1
    arrays, meta = ckpt.load_snapshot(d)
    assert meta["step"] == 1 and meta["clock"] == 0.5
    np.testing.assert_array_equal(arrays["a"], np.arange(3))


def test_load_snapshot_rejects_unknown_version(tmp_path):
    d = str(tmp_path)
    ckpt.save_snapshot(d, 1, {"a": np.arange(2)}, {})
    with open(os.path.join(d, "snap_1.json")) as f:
        meta = json.load(f)
    meta["snapshot_version"] = 999
    with open(os.path.join(d, "snap_1.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="version"):
        ckpt.load_snapshot(d, 1)


def test_load_snapshot_without_any_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_snapshot(str(tmp_path / "empty"))


def test_restore_checkpoint_validates_structure(tmp_path):
    d = str(tmp_path)
    tree = {"a": np.arange(4.0), "b": {"c": np.ones((2, 2))}}
    ckpt.save_checkpoint(d, tree, step=3)
    assert ckpt.latest_step(d) == 3
    out, step = ckpt.restore_checkpoint(d, tree)
    assert step == 3
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(d, {"a": np.arange(4.0)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_checkpoint(
            d, {"a": np.arange(4.0), "z": {"c": np.ones((2, 2))}})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_checkpoint(
            d, {"a": np.arange(4.0), "b": {"c": np.ones((2, 2), np.float32)}})


def test_tensor_checkpoint_round_trips_bitwise(tmp_path):
    """Tensor trees come back as tensors on the template's device and
    dtype, bitwise — bfloat16 included (carried as its bit pattern)."""
    gen = torch.Generator().manual_seed(0)
    tree = [{"w": torch.randn(3, 5, generator=gen),
             "proj": {"b": torch.randn(4, generator=gen)
                      .to(torch.bfloat16)}},
            {"w": torch.randn(2, generator=gen)}]
    ckpt.save_checkpoint(str(tmp_path), tree, step=1)
    like = [{"w": torch.zeros(3, 5),
             "proj": {"b": torch.zeros(4, dtype=torch.bfloat16)}},
            {"w": torch.zeros(2)}]
    out, _ = ckpt.restore_checkpoint(str(tmp_path), like)
    got, want = tree_leaves(out), tree_leaves(tree)
    assert [x.dtype for x in got] == [x.dtype for x in want]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [p for p, _, _ in ckpt.structure(tree)] == \
        ["0/proj/b", "0/w", "1/w"]


def test_latest_step_skips_halfwritten_npz(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, {"a": np.arange(3)}, step=1)
    with open(os.path.join(d, "ckpt_2.npz"), "wb") as f:
        np.savez(f, leaf_0=np.arange(3))       # no json marker
    assert ckpt.latest_step(d) == 1


def test_spec_checkpoint_validation_and_grid_key():
    with pytest.raises(ValueError, match="checkpoint_every"):
        _spec(checkpoint_every=-1).validated()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _spec(checkpoint_every=2).validated()
    with pytest.raises(ValueError, match="scan"):
        _spec(checkpoint_every=2, checkpoint_dir="unused",
              engine="vectorized").validated()
    # snapshot side effects are per-cell host state a folded grid cannot
    # replay: checkpointed cells always run alone
    assert _spec(checkpoint_every=2,
                 checkpoint_dir="unused").grid_key() is None
    assert _spec().grid_key() is not None
