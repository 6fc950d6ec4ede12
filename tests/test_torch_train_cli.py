"""The port's training launcher (`repro_torch.launch.train`), edge mode,
on the CPU.

- ``--mode edge --device cpu`` under a scenario writes one CSV row per
  eval and the spec beside it; the numbers are `Session(spec).run()`'s,
  bitwise, and the spec file reloads equal (in the port and in the
  reference).
- The command line parses to the reference's arguments, defaults
  included (plus ``--device``).
- ``--mode spmd --device cpu`` on a reduced MoE arch and on xlstm logs
  the reference's rows from the reference's initial state; on whisper,
  whose loss needs the frames the launcher does not make, both raise
  ``KeyError('frame_embeddings')``.
- ``--engine legacy`` and ``--engine vectorized`` write the reference
  launcher's CSV (from the reference's initial units); without
  ``--device`` and without a card the launcher raises rather than fall
  back to the CPU.
"""
import csv
import dataclasses
import sys

import numpy as np
import pytest
import torch

import repro.config as RC
import repro.launch.train as RTRAIN
import repro_torch.config as TC
from repro.api import ExperimentSpec as RSpec
from repro_torch.api import ExperimentSpec, Session
from repro_torch.launch import train as TRAIN

ARCH = "vgg9-torch-cli"
ARGS = ["--mode", "edge", "--arch", ARCH, "--clients", "4", "--rounds",
        "6", "--agg-interval", "3", "--eval-every", "2", "--n-train", "200",
        "--n-test", "50", "--iid", "--scenario", "straggler-bursts"]


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


def test_edge_mode_writes_csv_and_spec_matching_session(tmp_path, capsys):
    _register()
    path = str(tmp_path / "out" / "run.csv")
    spec, res = TRAIN.main(ARGS + ["--device", "cpu", "--csv", path])
    assert "final acc=" in capsys.readouterr().out
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(res.rounds) == 3         # one row per eval
    alone = Session(spec, device="cpu").run()
    assert alone.clock == res.clock
    assert alone.train_loss == res.train_loss
    assert alone.test_acc == res.test_acc
    assert [int(r["step"]) for r in rows] == alone.rounds
    for key, col in (("clock", alone.clock), ("train_loss", alone.train_loss),
                     ("test_acc", alone.test_acc),
                     ("test_loss", alone.test_loss)):
        assert [float(r[key]) for r in rows] == col, key
    back = ExperimentSpec.load(path + ".spec.json")
    assert back == spec
    assert back.scenario == "straggler-bursts" and back.n_clients == 4
    # the reference reads the port's spec file as its own
    assert RSpec.load(path + ".spec.json").to_json() == spec.to_json()


def test_command_line_parses_to_the_references_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(RTRAIN, "run_edge",
                        lambda args: seen.setdefault("args", args))
    monkeypatch.setattr("repro.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    for argv in ([], ARGS + ["--csv", "x.csv", "--policy", "rbs+rms",
                             "--no-estimate", "--scenario-seed", "3"]):
        seen.clear()
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        RTRAIN.main()
        ours = vars(TRAIN.parser().parse_args(argv))
        assert ours.pop("device") is None
        assert ours == vars(seen["args"])


def test_edge_spec_matches_the_references_spec():
    _register()
    args = TRAIN.parser().parse_args(ARGS)
    ours = TRAIN.edge_spec(args)
    theirs = RSpec(
        arch=ARCH, n_clients=4, partition="iid", n_train=200, n_test=50,
        seed=0, policy="hasfl", estimate=True, scenario="straggler-bursts",
        scenario_seed=7, rounds=6, eval_every=2, engine="scan",
        sfl=RC.SFLConfig(n_devices=4, agg_interval=3, lr=0.05))
    assert ours.to_json() == theirs.to_json()


SPMD_ARGS = ["--mode", "spmd", "--steps", "3", "--seq", "16", "--layers",
             "2", "--d-model", "64", "--clients", "2", "--batch", "2",
             "--lr", "3e-4", "--eval-every", "0"]


def _reference_main(monkeypatch, argv):
    monkeypatch.setattr("repro.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    RTRAIN.main()


def _spmd_rows_match_the_reference(tmp_path, monkeypatch, arch, steps):
    """``--mode spmd`` for ``steps`` steps on an fp32 copy of ``arch``
    (the launcher cuts it to 2 layers), started from the reference's
    initial state on both sides: the port's logged losses against the
    reference's rows within 1e-5."""
    import jax
    import repro.core.sfl as RSFL
    import repro_torch.core.sfl as TSFL
    from repro_torch.convert import params_from_numpy
    from repro_torch.training.optim import make_optimizer

    name = f"{arch}-cli-f32"
    for C in (RC, TC):
        C.register(dataclasses.replace(C.get_config(arch),
                                       arch_id=name, dtype="float32"))
    argv = SPMD_ARGS + ["--arch", name, "--steps", str(steps)]
    seen = {}
    r_make, t_make = RSFL.make_hasfl_train_step, TSFL.make_hasfl_train_step

    def r_recording(*a, **k):
        init, step = r_make(*a, **k)
        return (lambda rng: seen.setdefault("state", init(rng))), step

    def t_from_reference(model, **k):
        _, step = t_make(model, **k)
        opt = make_optimizer(k["optimizer_name"], k["lr"])

        def init(gen, device=None):
            state = jax.tree_util.tree_map(np.asarray, seen["state"])
            c, s = (params_from_numpy(state[p], model.cfg, device)
                    for p in ("client", "server"))
            return {"client": c, "server": s, "step": 0,
                    "opt": opt.init({"client": c, "server": s})}
        return init, step

    monkeypatch.setattr(RSFL, "make_hasfl_train_step", r_recording)
    monkeypatch.setattr(TSFL, "make_hasfl_train_step", t_from_reference)
    path = tmp_path / "ref.csv"
    _reference_main(monkeypatch, argv + ["--csv", str(path)])
    with open(path) as f:
        ref = [float(r["loss"]) for r in csv.DictReader(f)]
    rows = TRAIN.main(argv + ["--device", "cpu"])
    assert [r["step"] for r in rows] == list(range(1, steps + 1))
    np.testing.assert_allclose([r["loss"] for r in rows], ref, rtol=1e-5,
                               atol=1e-5)


def test_spmd_mode_on_an_moe_arch_logs_the_references_rows(tmp_path,
                                                           monkeypatch):
    """``--mode spmd`` on an fp32 copy of dbrx, cut by the launcher to 2
    layers (an MoE block in the client prefix, the lb term in the loss),
    3 Adam steps: started from the reference's initial state, the port's
    logged losses are the reference's rows within 1e-5."""
    _spmd_rows_match_the_reference(tmp_path, monkeypatch, "dbrx-132b", 3)


def test_spmd_mode_on_xlstm_logs_the_references_rows(tmp_path, monkeypatch):
    """``--mode spmd --arch xlstm-350m --steps 2`` on an fp32 copy, cut by
    the launcher to 2 layers (an mLSTM and an sLSTM block, both in the
    client prefix), 2 Adam steps: the reference's rows within 1e-5."""
    _spmd_rows_match_the_reference(tmp_path, monkeypatch, "xlstm-350m", 2)


def test_spmd_mode_on_whisper_raises_as_the_reference(monkeypatch):
    """The launcher's batch holds tokens and labels only: whisper's
    split loss asks for the frames and both packages raise."""
    argv = SPMD_ARGS + ["--arch", "whisper-medium", "--steps", "1"]
    with pytest.raises(KeyError, match="frame_embeddings"):
        _reference_main(monkeypatch, argv)
    with pytest.raises(KeyError, match="frame_embeddings"):
        TRAIN.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("engine", ["legacy", "vectorized"])
def test_edge_mode_engine_writes_the_references_csv(engine, tmp_path,
                                                    monkeypatch):
    """``--engine legacy|vectorized --device cpu`` against the reference
    launcher on the same command line, the port's session started from
    the reference's initial units: the same rows, steps and clocks,
    losses and accuracies within 1e-4, and the spec file of the same
    JSON."""
    import jax
    import repro_torch.api as TAPI
    from repro.api import Session as RSession

    _register()
    argv = ARGS + ["--engine", engine, "--rounds", "4"]
    ref_csv, our_csv = str(tmp_path / "ref.csv"), str(tmp_path / "ours.csv")
    _reference_main(monkeypatch, argv + ["--csv", ref_csv])
    spec = RSpec.load(ref_csv + ".spec.json")
    assert spec.engine == engine
    init = jax.tree_util.tree_map(np.asarray, RSession(spec).sim.units)
    monkeypatch.setattr(TAPI, "Session", lambda s, device=None: Session(
        s, device=device, init_units=init))
    ours, res = TRAIN.main(argv + ["--device", "cpu", "--csv", our_csv])
    assert ours.engine == engine
    assert ours.to_json() == spec.to_json()
    rows = {}
    for name, path in (("ref", ref_csv), ("ours", our_csv)):
        with open(path) as f:
            rows[name] = list(csv.DictReader(f))
    assert len(rows["ours"]) == len(rows["ref"]) == len(res.rounds) == 2
    for a, b in zip(rows["ours"], rows["ref"]):
        assert a.keys() == b.keys()
        assert a["step"] == b["step"] and a["clock"] == b["clock"]
        for key in ("train_loss", "test_acc", "test_loss"):
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)


def test_edge_mode_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the launcher would run on it")
    _register()
    with pytest.raises(RuntimeError, match="CUDA"):
        TRAIN.main(ARGS)


def test_result_converged_time_matches_reference():
    """The launcher's summary reads `SimResult.converged_time`, the
    reference's criterion."""
    from repro.core.sfl import SimResult as RResult
    from repro_torch.core.sfl import SimResult

    acc = [0.1, 0.2, 0.25, 0.25, 0.25, 0.25, 0.25, 0.3, 0.3]
    clock = list(np.arange(1.0, 10.0))
    for a in (acc, acc[:3], []):
        ours = SimResult(test_acc=a, clock=clock[:len(a)])
        theirs = RResult(test_acc=a, clock=clock[:len(a)])
        assert ours.converged_time() == theirs.converged_time()
