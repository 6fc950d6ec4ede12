"""The port's token-model serving path against the JAX reference, on the CPU.

`reduced()` configs of every token architecture (2 layers, d 128; the
MoE ones with 4 experts, jamba one mamba+attention period, whisper 2
encoder layers over 16 frames, internvl2 8 patches), and phi3 at hd 96,
take the reference's weights (``model.init(PRNGKey(1))``, carried across
by `repro_torch.convert.params_from_numpy`), the same numpy-seeded prompts
and the same modality stubs (``concrete_inputs`` at seed 0, as the
reference's ``serve.py`` adds them).  Compared: ``apply`` logits, prefill
logits and cache contents, 8 decode steps' logits, each step fed the
reference's greedy token (so a near-tie cannot cascade), and every MoE
call's router decisions.  On the CPU the port's kernels run their plain
versions and the reference its jnp forms.  Bars: fp32 within 1e-4 (the
two sides differ only in the order of fp32 sums); bf16 at
`tests/test_decode.py`'s bars (rtol 0.07, atol 0.05), as the two
frameworks round bf16 at other places.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.configs.input_shapes import concrete_inputs as r_inputs
from repro.models import build_model as r_build
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs.input_shapes import concrete_inputs as t_inputs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.serve import serve
from repro_torch.models import build_model as t_build
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.utils.tree import tree_leaves

ARCHS = ["qwen3-1.7b", "smollm-135m", "xlstm-350m", "glm4-9b",
         "phi3-mini-3.8b", "phi3-hd96", "dbrx-132b",
         "llama4-maverick-400b-a17b", "jamba-v0.1-52b", "whisper-medium",
         "internvl2-1b"]
# cases that are not a registered arch's `reduced()`: phi3 at its own
# head dim (reduced() sets 32), the flash path's hd 96
VARIANTS = {"phi3-hd96": ("phi3-mini-3.8b", dict(head_dim=96))}
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.07, atol=0.05)}
B, S, GEN = 2, 8, 8


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, dtype):
    base, extra = VARIANTS.get(arch, (arch, {}))
    return (dataclasses.replace(RC.reduced(RC.get_config(base)), dtype=dtype,
                                **extra),
            dataclasses.replace(TC.reduced(TC.get_config(base)), dtype=dtype,
                                **extra))


def _stubs(rcfg, tcfg):
    """The reference's and the port's modality stubs of a B x S prefill
    (seed 0, as the reference's ``serve.py``); {} for token-only models."""
    ref = r_inputs(rcfg, RC.InputShape("serve", S, B, "prefill"))
    got = t_inputs(tcfg, TC.InputShape("serve", S, B, "prefill"))
    return ({k: jnp.asarray(v) for k, v in ref.items() if k != "tokens"},
            {k: torch.as_tensor(v) for k, v in got.items() if k != "tokens"})


@functools.lru_cache(maxsize=None)
def _ref_weights(arch, dtype):
    rcfg, _ = _cfgs(arch, dtype)
    params = r_build(rcfg).init(jax.random.PRNGKey(1))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _f32(a):
    """An fp32 numpy copy (the port's caches are updated in place)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.array(a, np.float32)


class _Routing:
    """Each reference MoE call's router probabilities and top-k experts,
    in call order, beside the port's own for the same call.  The two
    packages' calls alternate in `_runs` (reference, then port), so the
    port's call takes the oldest reference record."""

    def __init__(self):
        self.queue, self.calls = [], []

    @contextlib.contextmanager
    def installed(self):
        r_dense, t_top_k = RM._moe_ffn_dense, TM.top_k_lower_first

        def ref_dense(params, xt, *, top_k, capacity_factor=1.25):
            probs = jax.nn.softmax(xt.astype(jnp.float32)
                                   @ params["w_router"], axis=-1)
            # the reference scans over its layers: record through a host
            # callback, in call order
            jax.debug.callback(
                lambda p, i: self.queue.append((np.asarray(p),
                                                np.asarray(i))),
                probs, jax.lax.top_k(probs, top_k)[1], ordered=True)
            return r_dense(params, xt, top_k=top_k,
                           capacity_factor=capacity_factor)

        def port_top_k(probs, k):
            jax.effects_barrier()
            ref_probs, ref_idx = self.queue.pop(0)
            vals, idx = t_top_k(probs, k)
            self.calls.append((ref_probs, ref_idx, _f32(probs), idx.numpy()))
            return vals, idx

        RM._moe_ffn_dense, TM.top_k_lower_first = ref_dense, port_top_k
        try:
            yield self
        finally:
            RM._moe_ffn_dense, TM.top_k_lower_first = r_dense, t_top_k


@functools.lru_cache(maxsize=None)
def _runs(arch, dtype):
    """Both packages on the same weights and prompts: apply logits,
    prefill logits and cache, GEN teacher-forced decode steps, and every
    MoE call's routing on both sides (`_Routing`)."""
    routing = _Routing()
    with routing.installed():
        out = _both(arch, dtype)
    assert not routing.queue
    out["routing"] = routing.calls
    return out


def _both(arch, dtype):
    rcfg, tcfg = _cfgs(arch, dtype)
    rm, tm = r_build(rcfg), t_build(tcfg)
    rp, tree = _ref_weights(arch, dtype)
    tp = params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, S))
    r_stub, t_stub = _stubs(rcfg, tcfg)
    r_batch = {"tokens": jnp.asarray(toks), **r_stub}
    t_batch = {"tokens": torch.as_tensor(toks), **t_stub}
    out = {"toks": toks, "tp": tp}
    out["apply"] = (_f32(rm.apply(rp, r_batch)[0]),
                    _f32(tm.apply(tp, t_batch)[0]))
    rl, rcache = rm.prefill(rp, r_batch, cache_len=S + GEN)
    tl, tcache = tm.prefill(tp, t_batch, cache_len=S + GEN)
    out["prefill"] = (_f32(rl), _f32(tl))
    out["cache"] = ([_f32(a) for a in jax.tree_util.tree_leaves(rcache)],
                    [_f32(a) for a in tree_leaves(tcache)])
    greedy = [np.array(jnp.argmax(rl[:, 0], -1))]
    r_steps, t_steps = [], []
    for i in range(GEN):
        pos = np.full((B,), S + i, np.int32)
        tok = greedy[-1][:, None]
        rl, rcache = rm.decode_step(rp, rcache, {
            "tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)})
        tl, tcache = tm.decode_step(tp, tcache, {
            "tokens": torch.as_tensor(tok), "positions": torch.from_numpy(pos)})
        r_steps.append(_f32(rl))
        t_steps.append(_f32(tl))
        greedy.append(np.array(jnp.argmax(rl[:, 0], -1)))
    out["decode"] = (np.stack(r_steps), np.stack(t_steps))
    out["greedy"] = np.stack(greedy, axis=1)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_match_reference(arch, dtype):
    ref, got = _runs(arch, dtype)["apply"]
    assert got.shape == ref.shape == (B, S, _cfgs(arch, dtype)[1].vocab_size)
    np.testing.assert_allclose(got, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch, dtype):
    ref, got = _runs(arch, dtype)["prefill"]
    assert got.shape == ref.shape and got.shape[:2] == (B, 1)
    np.testing.assert_allclose(got, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_reference(arch, dtype):
    """Every cache leaf (attention k, v, pos; the recurrent states), in the
    reference's flattening order."""
    ref, got = _runs(arch, dtype)["cache"]
    assert [a.shape for a in got] == [a.shape for a in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_reference(arch, dtype):
    ref, got = _runs(arch, dtype)["decode"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL[dtype])


MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]
NEAR_TIE = 2.0 ** -6    # relative gap of two router probabilities


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_matches_reference(arch, dtype):
    """The port's own top-k experts in every MoE call of apply, prefill and
    the decode steps: at fp32 bitwise the reference's; at bf16 the same
    except at near-ties (the two swapped experts' reference probabilities
    within ``NEAR_TIE`` of each other), which bf16 rounding elsewhere in
    the block may flip (none does at these seeds; PERF.md)."""
    calls = _runs(arch, dtype)["routing"]
    assert calls and len(calls) % (2 + GEN) == 0
    for ref_probs, ref_idx, probs, idx in calls:
        if dtype == "float32":
            np.testing.assert_array_equal(idx, ref_idx)
            np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)
            continue
        for t in np.where((idx != ref_idx).any(-1))[0]:
            moved = idx[t] != ref_idx[t]
            p = ref_probs[t][np.union1d(idx[t][moved], ref_idx[t][moved])]
            assert (p.max() - p.min()) / p.max() < NEAR_TIE, (t, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_reference_loop(arch):
    """`launch.serve.serve` on the CPU gives the greedy ids of a greedy
    loop over the reference's prefill/decode_step, at fp32."""
    runs = _runs(arch, "float32")
    _, tcfg = _cfgs(arch, "float32")
    res = serve(tcfg, runs["tp"], runs["toks"], GEN, device="cpu")
    np.testing.assert_array_equal(res.tokens, runs["greedy"])
    assert res.prefill_s > 0 and res.decode_s > 0


def test_serve_runs_prefill_and_decode_in_profiler_spans():
    """`serve` wraps its prefill and its decode loop in the spans that
    `repro_torch.trace --serve` splits the profile by, one each, in order,
    each covering its stage's matmuls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.trace import SERVE_SPANS

    _, tcfg = _cfgs("qwen3-1.7b", "float32")
    runs = _runs("qwen3-1.7b", "float32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(tcfg, runs["tp"], runs["toks"], GEN, device="cpu")
    events = [ev for ev in prof.events() if ev.device_type == DeviceType.CPU]
    spans = [ev for ev in events if ev.name in SERVE_SPANS]
    assert [ev.name for ev in spans] == list(SERVE_SPANS)
    prefill, decode = (ev.time_range for ev in spans)
    assert prefill.end <= decode.start
    mms = [ev.time_range.start for ev in events if ev.name == "aten::mm"]
    for tr in (prefill, decode):
        assert any(tr.start <= t < tr.end for t in mms)
    assert all(prefill.start <= t < decode.end for t in mms)


def test_xlstm_decode_after_prefill_starts_from_empty_state():
    """The reference's prefill leaves the mLSTM/sLSTM caches as initialized
    (`transformer.py` stack_prefill), so decode after prefill starts those
    blocks from the empty state; the port does the same."""
    rcfg, tcfg = _cfgs("xlstm-350m", "float32")
    runs = _runs("xlstm-350m", "float32")
    empty = [_f32(a) for a in jax.tree_util.tree_leaves(
        RT.cache_init(rcfg, B, S + GEN))]
    ref, got = runs["cache"]
    for a, b in zip(ref + got, empty + empty):
        np.testing.assert_array_equal(a, b)
    # so the first decode step equals one from a fresh cache
    tm = t_build(tcfg)
    tok = runs["greedy"][:, :1]
    fresh, _ = tm.decode_step(runs["tp"], tm.init_cache(B, S + GEN), {
        "tokens": torch.as_tensor(tok),
        "positions": torch.full((B,), S, dtype=torch.int32)})
    np.testing.assert_array_equal(_f32(fresh), runs["decode"][1][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_with_the_models_own_dtypes(arch):
    """`params_from_numpy` gives the leaves, shapes and types of the
    port's own init (norms, mLSTM gates, sLSTM weights, the MoE router and
    the mamba conv/B/C/dt/A/skip parameters fp32, the rest bf16), the
    types are the reference's own, and `params_to_numpy` gives the
    reference's values back."""
    _, tcfg = _cfgs(arch, "bfloat16")
    _, tree = _ref_weights(arch, "bfloat16")
    ported = params_from_numpy(tree, tcfg, "cpu")
    own = t_build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(ported)] == \
        [(tuple(a.shape), a.dtype) for a in tree_leaves(own)]
    assert {a.dtype for a in tree_leaves(own)} == {torch.float32,
                                                    torch.bfloat16}
    ref_types = ["float32" if a.dtype == np.float32 else "bfloat16"
                 for a in jax.tree_util.tree_leaves(tree)]
    assert [str(a.dtype).split(".")[1] for a in tree_leaves(ported)] \
        == ref_types
    back = params_to_numpy(ported)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("kind,arch", [
    pytest.param(kind, arch, id=kind if arch == "qwen3-1.7b"
                 else f"{kind}-{arch}")
    for arch in ("qwen3-1.7b", "whisper-medium", "internvl2-1b",
                 "whisper-fp32")
    for kind in ("prefill", "decode")])
def test_concrete_inputs_match_reference(kind, arch):
    """The same keys in the same order and the same numbers: ids and masks
    bitwise in their own types, the embedding stubs bitwise once the
    reference's bf16 (or fp32) draws are widened to fp32."""
    base = "whisper-medium" if arch == "whisper-fp32" else arch
    over = dict(dtype="float32") if arch == "whisper-fp32" else {}
    shape_r = RC.InputShape("serve", 16, 3, kind)
    shape_t = TC.InputShape("serve", 16, 3, kind)
    ref = r_inputs(dataclasses.replace(RC.get_config(base), **over), shape_r,
                   seed=5)
    got = t_inputs(dataclasses.replace(TC.get_config(base), **over), shape_t,
                   seed=5)
    assert list(got) == list(ref)
    for key in ref:
        if key.endswith("_embeddings"):
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key],
                                          np.asarray(ref[key], np.float32))
        else:
            assert got[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_programs_match_reference(arch):
    """`reduced()` keeps the family's block kinds (xlstm: pattern
    "mlstm,slstm", d 128, 4 heads) and the program is the reference's."""
    rcfg, tcfg = _cfgs(arch, "float32")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert TT.layer_program(tcfg) == RT.layer_program(rcfg)
    if tcfg.is_enc_dec:
        assert TT.encoder_program(tcfg) == RT.encoder_program(rcfg)
    if arch == "xlstm-350m":
        assert (tcfg.ssm_pattern, tcfg.d_model, tcfg.n_heads) == \
            ("mlstm,slstm", 128, 4)


def test_unported_families_and_cnn_decode_raise():
    """Every token family builds; what still raises is a CNN's decode path
    and the token models' training loss (the next slice)."""
    for arch in TC.list_archs():
        if not TC.get_config(arch).is_cnn:
            t_build(TC.reduced(TC.get_config(arch)))
    cnn = t_build(TC.get_config("vgg16-cifar"))
    for fn in (cnn.init_cache, cnn.prefill, cnn.decode_step):
        with pytest.raises(NotImplementedError, match="decode"):
            fn(None, None)
    for arch in ("qwen3-1.7b", "dbrx-132b", "whisper-medium"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_build(TC.reduced(TC.get_config(arch))).loss(None, None)
