"""The port's token-model serving path against the JAX reference, on the CPU.

`reduced()` qwen3-1.7b, smollm-135m and xlstm-350m (2 layers, d 128) take
the reference's weights (``model.init(PRNGKey(1))``, carried across by
`repro_torch.convert.params_from_numpy`) and the same numpy-seeded prompts.
Compared: ``apply`` logits, prefill logits and cache contents, and 8
decode steps' logits, each step fed the reference's greedy token (so a
near-tie cannot cascade).  On the CPU the port's kernels run their plain
versions and the reference its jnp forms.  Bars: fp32 within 1e-4 (the
two sides differ only in the order of fp32 sums); bf16 at
`tests/test_decode.py`'s bars (rtol 0.07, atol 0.05), as the two
frameworks round bf16 at other places.
"""
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
from repro.models import transformer as RT
from repro_torch.configs.input_shapes import concrete_inputs as t_inputs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.serve import serve
from repro_torch.models import build_model as t_build
from repro_torch.models import transformer as TT
from repro_torch.utils.tree import tree_leaves

ARCHS = ["qwen3-1.7b", "smollm-135m", "xlstm-350m"]
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
    return (dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype),
            dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype=dtype))


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


@functools.lru_cache(maxsize=None)
def _runs(arch, dtype):
    """Both packages on the same weights and prompts: apply logits,
    prefill logits and cache, and GEN teacher-forced decode steps."""
    rcfg, tcfg = _cfgs(arch, dtype)
    rm, tm = r_build(rcfg), t_build(tcfg)
    rp, tree = _ref_weights(arch, dtype)
    tp = params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, S))
    out = {"toks": toks, "tp": tp}
    out["apply"] = (_f32(rm.apply(rp, {"tokens": jnp.asarray(toks)})[0]),
                    _f32(tm.apply(tp, {"tokens": torch.as_tensor(toks)})[0]))
    rl, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)},
                            cache_len=S + GEN)
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks)},
                            cache_len=S + GEN)
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
    assert got.shape == ref.shape == (B, S, TC.reduced(
        TC.get_config(arch)).vocab_size)
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
    port's own init (norms, mLSTM gates and sLSTM weights fp32, the rest
    bf16), and `params_to_numpy` gives the reference's values back."""
    _, tcfg = _cfgs(arch, "bfloat16")
    _, tree = _ref_weights(arch, "bfloat16")
    ported = params_from_numpy(tree, tcfg, "cpu")
    own = t_build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(ported)] == \
        [(tuple(a.shape), a.dtype) for a in tree_leaves(own)]
    assert {a.dtype for a in tree_leaves(own)} == {torch.float32,
                                                    torch.bfloat16}
    back = params_to_numpy(ported)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_concrete_inputs_match_reference(kind):
    shape_r = RC.InputShape("serve", 16, 3, kind)
    shape_t = TC.InputShape("serve", 16, 3, kind)
    ref = r_inputs(RC.get_config("qwen3-1.7b"), shape_r, seed=5)
    got = t_inputs(TC.get_config("qwen3-1.7b"), shape_t, seed=5)
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_programs_match_reference(arch):
    """`reduced()` keeps the family's block kinds (xlstm: pattern
    "mlstm,slstm", d 128, 4 heads) and the program is the reference's."""
    rcfg, tcfg = _cfgs(arch, "float32")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert TT.layer_program(tcfg) == RT.layer_program(rcfg)
    if arch == "xlstm-350m":
        assert (tcfg.ssm_pattern, tcfg.d_model, tcfg.n_heads) == \
            ("mlstm,slstm", 128, 4)


def test_unported_families_and_cnn_decode_raise():
    moe = dataclasses.replace(TC.get_config("qwen3-1.7b"), family=TC.MOE,
                              n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build(moe)
    cnn = t_build(TC.get_config("vgg16-cifar"))
    for fn in (cnn.init_cache, cnn.prefill, cnn.decode_step):
        with pytest.raises(NotImplementedError, match="decode"):
            fn(None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build(TC.reduced(TC.get_config("qwen3-1.7b"))).loss(None, None)
