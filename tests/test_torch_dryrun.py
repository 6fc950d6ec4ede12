"""The port's dry-run tools (`launch.roofline`, `launch.dryrun`,
`launch.perf`) on the CPU: the analytic model FLOPs and the dry-run's
tables against the reference's, the counting on hand-reckoned cases, and
every kind of combination run on ``meta`` tensors at reduced widths on
the production mesh.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when imported, which would change every later JAX test in the
same process; its tables and two helpers are read from its source
instead.
"""
import ast
import dataclasses
import json
import math
import pathlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.config as RC
import repro_torch.config as TC
from repro.launch import roofline as RRL
from repro_torch.dist import sharding as TSH
from repro_torch.kernels import meta as META
from repro_torch.kernels import ops as TOPS
from repro_torch.launch import dryrun as DR
from repro_torch.launch import perf as PF
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MeshShape

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_dryrun():
    """SKIPS, ASSIGNED, SLIDING_WINDOW_500K and the two helpers of the
    reference's dry-run, from its source (not imported: see above)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    tree = ast.parse(src)
    ns = {"dataclasses": dataclasses, "SSM": RC.SSM,
          "ModelConfig": RC.ModelConfig, "InputShape": RC.InputShape}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in (
                "SKIPS", "ASSIGNED", "SLIDING_WINDOW_500K"):
            ns[node.targets[0].id] = ast.literal_eval(node.value)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in (
                "variant_config", "choose_cut_reps"):
            exec(compile(ast.Module([node], []), "ref", "exec"), ns)
    return ns


@pytest.mark.parametrize("arch", DR.ASSIGNED)
def test_analytic_model_flops_equal_the_references(arch):
    for name in TC.INPUT_SHAPES:
        assert RL.analytic_model_flops(
            TC.get_config(arch), TC.INPUT_SHAPES[name]) == \
            RRL.analytic_model_flops(RC.get_config(arch),
                                     RC.INPUT_SHAPES[name])


def test_dryrun_tables_equal_the_references():
    ref = _ref_dryrun()
    assert DR.SKIPS.keys() == ref["SKIPS"].keys()
    assert DR.ASSIGNED == ref["ASSIGNED"]
    assert DR.SLIDING_WINDOW_500K == ref["SLIDING_WINDOW_500K"]
    for arch in DR.ASSIGNED:
        for name in TC.INPUT_SHAPES:
            got = DR.variant_config(TC.get_config(arch),
                                    TC.INPUT_SHAPES[name])
            want = ref["variant_config"](RC.get_config(arch),
                                         RC.INPUT_SHAPES[name])
            assert got.sliding_window == want.sliding_window
        for n in (16, 32):
            for reps in (1, 8, 24, 40):
                assert DR.choose_cut_reps(TC.get_config(arch), n, reps) == \
                    ref["choose_cut_reps"](RC.get_config(arch), n, reps)
    assert RL._WIRE_MULT == RRL._WIRE_MULT


def test_h100_spec_and_no_tpu_numbers_in_the_port():
    hw = TC.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (989e12, 3.35e12,
                                                        80e9)
    assert hw.nvlink_bw == 450e9 and hw.link_bw == 50e9
    for path in (ROOT / "src/repro_torch").rglob("*.py"):
        text = path.read_text()
        for tpu in ("197e12", "819e9", "TPU_V5E", "v5e"):
            assert tpu not in text, (path, tpu)


def test_matmul_is_2mnk_flops_and_its_operands_bytes():
    m, k, n = 48, 80, 24
    a = torch.empty(m, k, device="meta")
    b = torch.empty(k, n, device="meta")
    cost = RL.CostMode()
    with FlopCounterMode(display=False) as fc, cost:
        c = a @ b
        c.t()                        # a view: no bytes, no storage
    assert fc.get_total_flops() == 2 * m * n * k
    assert cost.bytes == 4 * (m * k + k * n + m * n)
    assert cost.peak() == (4.0 * m * n, 4 * m * n, 0)
    del c


def test_cost_mode_frees_and_splits_gradients():
    """Storages made under the mode count while alive; one of a parameter
    shape counts as a gradient, scaled by ``grad_ratio``; an in-place op
    makes no new storage."""
    a, p, b = (torch.empty(s, device="meta") for s in (100, (8, 8), 10))
    cost = RL.CostMode(param_shapes=[(8, 8)])
    with cost:
        x = a + 1             # 400 bytes of activation
        g = p * 2             # 256 bytes of gradient
        g.add_(1)             # in place: no new storage
        del x
        b * 2                 # 40 bytes, freed at once
    assert cost.peak() == (656.0, 400, 256)
    assert cost.peak(act_div=4, grad_ratio=0.5) == (228.0, 400, 256)
    del g


def test_hand_reckoned_collectives():
    """One embedding [64, 32] bf16 on a (data 4, model 2) mesh in a
    prefill of 128 tokens: spec (model, data), a 512-byte shard; the FSDP
    all-gather of the shard (512 bytes) and the tensor-parallel
    all-reduce of [128/4 tokens, 32] bf16 activations (2048 bytes, twice
    on the wire); a train step gathers it for the forward and the
    backward, reduce-scatters its gradient (512 · 4) and all-reduces the
    activations forward and backward."""
    mesh = MeshShape({"data": 4, "model": 2})
    params = {"embed": torch.empty(64, 32, dtype=torch.bfloat16,
                                   device="meta")}
    sh = TSH.state_shardings(params, mesh)
    assert tuple(sh["embed"].spec) == ("model", "data")
    assert sh["embed"].local_bytes((64, 32), 2) == 512
    pre = RL.plan_collectives(kind="prefill", params=params, param_sh=sh,
                              mesh=mesh, tokens=128)
    assert pre.bytes_by_op == {"all-gather": 512.0, "all-reduce": 4096.0}
    assert pre.count_by_op == {"all-gather": 1, "all-reduce": 1}
    train = RL.plan_collectives(kind="train", params=params, param_sh=sh,
                                mesh=mesh, tokens=128)
    assert train.bytes_by_op == {"all-gather": 1024.0,
                                 "reduce-scatter": 2048.0,
                                 "all-reduce": 8192.0}
    rf = RL.analyze(2 * 989e12, 2 * 3.35e12, pre, chips=2)
    assert math.isclose(rf.t_compute, 1.0) and math.isclose(rf.t_memory,
                                                            1.0)
    assert math.isclose(rf.t_collective, 4608 / 50e9)
    assert rf.bottleneck in ("compute", "memory")


@pytest.mark.parametrize("sq,sk,causal,window", [
    (7, 7, True, 0), (9, 9, True, 3), (5, 12, False, 0), (16, 16, True, 16),
    (16, 16, True, 40), (6, 6, False, 2)])
def test_stand_in_attention_counts_the_kernels_pairs(sq, sk, causal, window):
    want = sum(1 for i in range(sq) for j in range(sk)
               if (not causal or j <= i)
               and (not window or j > i - window))
    assert META.causal_pairs(sq, sk, causal, window) == want
    q = torch.empty(2, sq, 4, 32, device="meta", requires_grad=True)
    k = torch.empty(2, sk, 2, 32, device="meta", requires_grad=True)
    cost = RL.CostMode()
    with cost:
        out = TOPS.flash_attention(q, k, k, causal=causal, window=window)
        assert out.shape == q.shape and out.is_meta
        out.sum().backward()
    assert cost.extra_flops == 3.5 * 4 * 2 * 4 * want * 32
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert not TOPS._on_card(q)


def _register(arch):
    name = f"{arch}-dryrun-test"
    TC.register(dataclasses.replace(TC.reduced(TC.get_config(arch)),
                                    arch_id=name))
    return name


KINDS = {"train": TC.InputShape("t", 32, 16, "train"),
         "prefill": TC.InputShape("p", 64, 16, "prefill"),
         "decode": TC.InputShape("d", 64, 32, "decode"),
         "long": TC.InputShape("long_500k", 256, 1, "decode")}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b", "xlstm-350m",
                                  "jamba-v0.1-52b", "whisper-medium",
                                  "internvl2-1b"])
def test_run_combo_is_ok_for_each_kind(arch):
    name = _register(arch)
    for kind, shape in KINDS.items():
        if arch == "whisper-medium" and kind == "long":
            rec = DR.run_combo("whisper-medium", "long_500k", False)
            assert rec["status"] == "skipped"
            continue
        rec = DR.run_combo(name, shape.name, False, shape=shape)
        assert rec["status"] == "ok", (kind, rec)
        assert rec["chips"] == 256 and rec["mesh"] == "single"
        rf = rec["roofline"]
        assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
        assert rf["t_collective_s"] > 0
        assert 0 < rec["per_device_bytes"] < TC.H100_SXM.hbm_bytes
        assert rec["fits_h100_80g"]
        if kind == "train":
            assert rec["n_clients"] == 16 and rec["cut_reps"] >= 0
            assert rec["memory"]["activation_divisor"] == 16
        if kind == "long" and TC.get_config(arch).family != TC.SSM:
            assert rec["window"] == DR.SLIDING_WINDOW_500K
    assert not torch.distributed.is_initialized()


def test_dryrun_main_writes_records(tmp_path):
    out = tmp_path / "dr"
    for argv in (["--arch", "qwen3-1.7b", "--shape", "long_500k"],
                 ["--arch", "whisper-medium", "--shape", "long_500k",
                  "--mesh", "multi", "--no-cost"]):
        with pytest.raises(SystemExit) as e:
            DR.main(argv + ["--out", str(out)])
        assert e.value.code == 0
    rec = json.loads((out / "qwen3-1.7b_long_500k_single.json").read_text())
    assert rec["status"] == "ok" and rec["fits_h100_80g"]
    assert rec["window"] == 8192 and rec["cache_len"] == 8192
    skip = json.loads((out / "whisper-medium_long_500k_multi.json")
                      .read_text())
    assert skip["status"] == "skipped"
    rows = DR.table(str(out)).splitlines()
    assert len(rows) == 4 and rows[2].startswith(
        "| qwen3-1.7b | long_500k | single | ok |")
    assert rows[3].split(" | ")[3:7] == ["skipped", "-", "-", "-"]


def test_perf_experiments_report_deltas_and_restore_the_hooks():
    assert sorted(PF.EXPERIMENTS) == sorted(
        ["baseline", "no_remat", "accum_2x", "seq_parallel",
         "cache_replicated", "flat_experts"])
    name = _register("qwen3-1.7b")
    hooks = (TSH.make_shard_fn, DR.make_shard_fn, TSH.cache_shardings,
             TSH.auto_param_spec, DR.FORCE_REMAT)
    shape = KINDS["train"]
    base = PF.run_experiment(name, shape.name, "baseline", shape=shape)
    assert base["status"] == "ok"
    assert all(v == 0 for k, v in base["vs_baseline"].items()
               if k != "bottleneck")
    seq = PF.run_experiment(name, shape.name, "seq_parallel", shape=shape)
    assert seq["vs_baseline"]["t_collective_s"] > 0
    assert seq["vs_baseline"]["per_device_bytes"] < 0
    assert (TSH.make_shard_fn, DR.make_shard_fn, TSH.cache_shardings,
            TSH.auto_param_spec, DR.FORCE_REMAT) == hooks
