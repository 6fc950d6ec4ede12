"""The port's `Session` against the reference's, on the CPU.

The same spec runs through `repro.api.Session` (scan engine, with its
kernel knobs on: the im2col conv and the fused-update oracle on the CPU)
and through `repro_torch.api.Session(device="cpu")` started from the
reference's initial units.  The host plane is the same numpy code on the
same seeded streams, so decisions, clocks and gather plans must be
bitwise equal; losses, accuracies and final parameters agree within 1e-4
(fp32, different summation order).
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
from repro_torch.api import runners as TRUN
from repro_torch.utils.tree import tree_leaves

ARCH = "vgg9-torch-session"
TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    # mixed client/server units, full cohort
    "fixed-cut3": dict(policy="fixed(b=8,cut=3)"),
    # the BCD controller's own decisions
    "hasfl": dict(policy="hasfl", estimate=False),
    # deadline faults (the participation lane of the update): at this
    # seed a factor of 1.002 x the median leaves one survivor of four,
    # 1.0 drops everyone (every round holds its params)
    "deadline-lone": dict(policy="fixed(b=8,cut=3)", fault_mode="deadline",
                          deadline_factor=1.002),
    "deadline-none": dict(policy="fixed(b=8,cut=3)", fault_mode="deadline",
                          deadline_factor=1.0),
    # random batch sizes past the shard pools and random cuts: padded rows
    # (b_pad = 64 > pool size 50) and heterogeneous cuts
    "rbs-rms": dict(policy="rbs+rms"),
}


@pytest.fixture(autouse=True)
def _one_thread():
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


def _spec_kw(case, sfl_cls):
    return dict(arch=ARCH, n_clients=4, partition="iid", n_train=200,
                n_test=50, rounds=6, eval_every=3,
                sfl=sfl_cls(lr=0.05, agg_interval=3), **CASES[case])


def _record_plans(sim):
    plans = []
    draw = sim.store.segment_indices

    def recording(*a):
        plans.append(draw(*a))
        return plans[-1]

    sim.store.segment_indices = recording
    return plans


@pytest.mark.parametrize("case", sorted(CASES))
def test_session_matches_reference(case):
    _register()
    ref = RSession(RSpec(conv_impl="kernel", update_impl="kernel",
                         **_spec_kw(case, RC.SFLConfig)))
    init = jax.tree_util.tree_map(np.asarray, ref.sim.units)
    ref_plans = _record_plans(ref.sim)
    r = ref.run()

    port = TSession(TSpec(**_spec_kw(case, TC.SFLConfig)), device="cpu",
                    init_units=init)
    port_plans = _record_plans(port.sim)
    t = port.run()

    for name in ("b_history", "cut_history"):
        a, b = getattr(r, name), getattr(t, name)
        assert len(a) == len(b) and all(
            np.array_equal(x, y) for x, y in zip(a, b)), name
    assert t.clock == r.clock
    assert t.rounds == r.rounds
    assert len(port_plans) == len(ref_plans)
    for x, y in zip(port_plans, ref_plans):
        np.testing.assert_array_equal(x, y)
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   err_msg=name, **TOL)
    r_leaves = jax.tree_util.tree_leaves(ref.sim._stacked)
    t_leaves = tree_leaves(port.sim._stacked)
    assert len(r_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, r_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if case.startswith("deadline"):
        part = port.sim._segment_participation(0, 1, r.b_history[0],
                                               r.cut_history[0])
        assert part.sum() == (1 if case == "deadline-lone" else 0)
    if case == "rbs-rms":
        assert max(int(np.max(b)) for b in t.b_history) > 50


def test_update_impl_kernel_plain_path_matches_inline():
    """On the CPU, ``update_impl="kernel"`` (the fused op's plain version)
    and ``None`` (the inline algebra) give the same run."""
    _register()
    kw = _spec_kw("deadline-lone", TC.SFLConfig)
    runs = [TSession(TSpec(update_impl=impl, **kw), device="cpu").run()
            for impl in (None, "kernel")]
    np.testing.assert_allclose(runs[0].train_loss, runs[1].train_loss,
                               rtol=1e-6, atol=1e-6)
    assert runs[0].clock == runs[1].clock


def test_spec_json_round_trips_from_reference():
    """A spec file written by the reference loads in the port unchanged."""
    text = RSpec(arch="vgg16-cifar", n_clients=8, policy="fixed(b=8,cut=3)",
                 conv_impl="kernel").to_json()
    spec = TSpec.from_json(text)
    assert spec.to_json() == text


def test_runner_table_turns_both_kernels_on_for_cuda():
    spec = TSpec(arch="vgg16-cifar")
    on_card = TRUN.apply_choice(spec, "cuda")
    assert (on_card.conv_impl, on_card.update_impl) == ("kernel", "kernel")
    assert TRUN.apply_choice(spec, "cpu") == spec
