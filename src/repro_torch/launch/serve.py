"""Batched serving driver: prefill a prompt batch, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduce --batch 4 --prompt-len 32 --gen 32 [--device cpu]

Port of `repro.launch.serve`, with the same flags and printout, plus
``--device`` (default: the CUDA card, raising without one; ``cpu`` runs
the kernels' plain versions).  As in the reference, ``--reduce`` is a
``store_true`` flag that defaults to True, so the CLI always serves the
reduced config; a full-width run calls `serve` directly (as
``chip_smoke.py`` does).  As the reference's ``main``, the prefill batch
carries the family's modality stubs (whisper's audio frames, internvl2's
patches and mask) from ``concrete_inputs`` at seed 0.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.trace import span

# The full-width serving traffic of ``chip_smoke.py``'s serve phases and of
# ``python -m repro_torch.trace --serve``: ``batch`` prompts of ``prompt``
# ids drawn with ``seed`` (`seeded_inputs`), then ``gen`` greedy steps.
FULL_WIDTH_TRAFFIC = dict(batch=8, prompt=512, gen=32, seed=0)


@dataclass
class ServeResult:
    tokens: np.ndarray      # [B, gen + 1] greedy ids (prefill's, then each step's)
    prefill_s: float        # host clock around prefill, ending in a device sync
    decode_s: float         # the same around all ``gen`` decode steps
    logits: np.ndarray      # [B, V] fp32 logits of the last step

    @property
    def tokens_per_s(self) -> float:
        """Generated tokens per second of decode, summed over the batch."""
        steps = self.tokens.shape[1] - 1
        return steps * self.tokens.shape[0] / self.decode_s


def seeded_inputs(cfg, batch: int, prompt: int, seed: int, device):
    """The port's init of ``cfg`` from ``seed`` (a `torch.Generator` on
    ``device``) and ``batch`` prompts of ``prompt`` ids from
    ``numpy.random.default_rng(seed)``."""
    from repro_torch.models import build_model

    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(seed), device)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt))
    return params, prompts


def stub_inputs(cfg, batch: int, prompt: int, device) -> dict:
    """The prefill batch's modality stubs, as the reference's ``main``
    adds them: `concrete_inputs` of a ``batch`` x ``prompt`` prefill at
    seed 0, every key but ``tokens``, as tensors on ``device``."""
    from repro_torch.config import InputShape
    from repro_torch.configs.input_shapes import concrete_inputs

    shape = InputShape("serve", prompt, batch, "prefill")
    return {k: torch.as_tensor(v, device=device)
            for k, v in concrete_inputs(cfg, shape).items() if k != "tokens"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, tokens, gen: int, device=None) -> ServeResult:
    """Prefill ``tokens`` ([B, S] ids, with the family's `stub_inputs`),
    then ``gen`` greedy decode steps against a cache of ``S + gen``
    positions, with ``params`` already on ``device``.  The two stages run
    in the profiler spans ``serve.prefill`` and ``serve.decode``, each
    ending in a device sync; the stubs are made before either."""
    from repro_torch.models import build_model

    device = resolve(device)
    model = build_model(cfg)
    toks = torch.as_tensor(np.asarray(tokens), device=device)
    b, s = toks.shape
    batch = {"tokens": toks, **stub_inputs(cfg, b, s, device)}
    _sync(device)
    t0 = time.perf_counter()
    with span("serve.prefill"):
        logits, cache = model.prefill(params, batch, cache_len=s + gen)
        _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = logits[:, 0].argmax(dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    with span("serve.decode"):
        for i in range(gen):
            step = {"tokens": tok[:, None],
                    "positions": torch.full((b,), s + i, dtype=torch.int32,
                                            device=device)}
            logits, cache = model.decode_step(params, cache, step)
            tok = logits[:, 0].argmax(dim=-1)
            out.append(tok)
        _sync(device)
    t_decode = time.perf_counter() - t0
    return ServeResult(torch.stack(out, dim=1).cpu().numpy(), t_prefill,
                       t_decode, logits[:, 0].float().cpu().numpy())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduce", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32, dest="prompt_len")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.config import get_config, reduced

    device = resolve(args.device)
    cfg = reduced(get_config(args.arch)) if args.reduce \
        else get_config(args.arch)
    b, s = args.batch, args.prompt_len
    params, prompts = seeded_inputs(cfg, b, s, args.seed, device)
    res = serve(cfg, params, prompts, args.gen, device)
    print(f"prefill[{b}x{s}] {res.prefill_s*1e3:.1f} ms")
    print(f"decode {args.gen} steps: {res.decode_s*1e3:.1f} ms "
          f"({res.tokens_per_s:.1f} tok/s aggregate)")
    print("sample:", res.tokens[0][:16])
    return res


if __name__ == "__main__":
    main()
