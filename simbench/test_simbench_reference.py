"""The output check on the CPU, at small sizes of each cell: a sound run of
the program agrees with the plain reference; the cell's control (the
reference in the next precision down) and each fault planted in the
program's timed path come out not correct."""
import numpy as np
import pytest
import torch

from repro_torch.core import split as SP
from repro_torch.data.pipeline import DeviceClientStore

from simbench import cell as C
from simbench.harness import run_cell
from simbench.reference.params import leaves
from simbench.reference.rounds import first_rounds

BENCH = C.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _register(name: str, program_arch: str, model: dict) -> None:
    """Register the small model with the program under its own name, as
    its program architecture with the small sizes.  smollm-tiny runs in
    fp32: in bf16 the program's plain update (the CPU's path) rounds each
    client's step before the Eq. 4/7 mean, where its kernel on the card
    and the reference round once, so only the card checks the bf16 cell."""
    import dataclasses

    from repro_torch import config as RC

    if name == program_arch:
        return
    RC.register(dataclasses.replace(
        RC.get_config(program_arch),
        **{k: (tuple(v) if isinstance(v, list) else v)
           for k, v in model.items()}))


def small(cell):
    """The cell at a size the CPU runs in seconds, its reference module's
    ``SMALL`` (vgg9-cifar-small, smollm-tiny in fp32, a few clients), an
    eval every 4 rounds, I = 2."""
    size = cell.ref.SMALL
    name = size["model"]["arch_id"]
    _register(name, size["program_arch"], size["model"])
    cell.config["arch_id"] = name
    cell.config["model"].update(size["model"])
    cell.traffic.update(size["traffic"])
    cell.traffic["eval_every"] = 4
    cell.traffic["sfl"] = dict(cell.traffic["sfl"], agg_interval=2)


def _run(name, seed=5):
    return run_cell(BENCH, name, seed, 0.05, False, device="cpu",
                    cell_edit=small)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-2:] == ["checks", "_readings"]


def _unchanged(monkeypatch):
    monkeypatch.setattr(SP, "hasfl_round_update",
                        lambda stacked, *a, **k: stacked)


def _batch_fault(monkeypatch, edit):
    real = DeviceClientStore.device_batch

    def broken(arrays, idx, row_mask):
        return edit(real(arrays, idx, row_mask))
    monkeypatch.setattr(DeviceClientStore, "device_batch",
                        staticmethod(broken))


def _half(monkeypatch):
    def edit(batch):
        mask = batch["loss_mask"].clone()
        rows = mask.reshape(mask.shape[0], mask.shape[1], -1)[..., 0]
        keep = torch.ceil(rows.sum(dim=1, keepdim=True) / 2)
        pos = torch.arange(rows.shape[1])[None, :]
        cut = (pos < keep).to(mask.dtype)
        batch["loss_mask"] = mask * cut.reshape(
            cut.shape + (1,) * (mask.dim() - 2))
        return batch
    _batch_fault(monkeypatch, edit)


def _label(monkeypatch):
    def edit(batch):
        lab = batch["labels"].clone()
        lab[:, 0] = (lab[:, 0] + 1) % 10      # each client's first sample
        batch["labels"] = lab
        return batch
    _batch_fault(monkeypatch, edit)


def _no_eq7(monkeypatch):
    real = SP.hasfl_round_update

    def broken(stacked, grads, masks, do_agg, *a, **k):
        return real(stacked, grads, masks, False, *a, **k)
    monkeypatch.setattr(SP, "hasfl_round_update", broken)


FAULTS = {"unchanged": _unchanged, "half": _half, "label": _label,
          "no_eq7": _no_eq7}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = C.find_cell(BENCH, name)
    small(cell)
    from simbench.reference.params import make_units

    units0 = make_units(cell.ref, cell.arch, 9, "cpu")
    ref = first_rounds(cell.ref, cell.arch, cell.traffic, 9, units0, "cpu")
    alt = first_rounds(cell.ref, cell.arch, cell.traffic, 9, units0, "cpu",
                       variant=cell.check["control"])
    ok, rows = C.verdict(C.compare(alt, ref), cell.check["limits"])
    assert not ok, rows
    assert all(np.isfinite(v) for _, v, _ in rows)
    assert len(leaves(units0)) == len(ref["grad1"])
