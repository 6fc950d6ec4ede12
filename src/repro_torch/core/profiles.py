"""Per-layer computational profiles (paper notation ρ, ϖ, ψ, χ, δ).

For every cut point ``j`` (1-based, ``j = 1..L``) of a model we provide:

- ``rho[j]``    cumulative FP FLOPs of layers 1..j, per data sample
- ``bwd[j]``    cumulative BP FLOPs of layers 1..j, per data sample (ϖ)
- ``psi[j]``    activation bits at cut j, per data sample
- ``chi[j]``    activation-gradient bits at cut j, per data sample
- ``delta[j]``  client-side sub-model bits for cut j (cumulative params)
- ``g_sq[j]``   per-layer bounded 2nd moment G_j² (Assumption 2)
- ``sigma_sq[j]`` per-layer gradient-variance constant σ_j²

G²/σ² are *constants of the loss landscape*: the simulator estimates them
online (`convergence.estimate_constants`); the default prior scales them
with per-layer parameter counts, which preserves the optimizer's relative
trade-offs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.config import ModelConfig, CNN
from repro_torch.models.transformer import layer_program


@dataclass
class LayerProfile:
    """Arrays indexed 0..L-1 (cut j = index+1); cumulative where noted."""
    rho: np.ndarray        # cumulative fwd FLOPs / sample
    bwd: np.ndarray        # cumulative bwd FLOPs / sample
    psi: np.ndarray        # activation bits at cut / sample
    chi: np.ndarray        # activation-grad bits at cut / sample
    delta: np.ndarray      # cumulative client-side param bits
    params: np.ndarray     # per-layer param counts
    g_sq: np.ndarray       # per-layer G_j^2
    sigma_sq: np.ndarray   # per-layer sigma_j^2

    @property
    def n_layers(self) -> int:
        return len(self.rho)

    @property
    def total_fwd(self) -> float:
        return float(self.rho[-1])

    @property
    def total_bwd(self) -> float:
        return float(self.bwd[-1])

    def g_sq_cum(self) -> np.ndarray:
        return np.cumsum(self.g_sq)

    def sigma_sq_total(self) -> float:
        return float(self.sigma_sq.sum())


BWD_MULT = 2.0          # standard: backward ~ 2x forward FLOPs
# Priors for the Assumption-2 constants: distributed over layers
# proportionally to parameter count and normalized so the variance and
# drift terms are commensurate with eps under the Table-I defaults
# (beta=0.05, gamma=5e-4, I=15, N=20, eps=0.1).  The simulator replaces
# them with online estimates (convergence.estimate_constants); the
# optimizer only depends on their *relative* layer distribution + scale.
_G_SQ_TOTAL = 9.0e4      # sum_j G_j^2 over the whole model
_SIGMA_SQ_TOTAL = 4.0e5  # sum_j sigma_j^2 over the whole model


def _assumption2_priors(params: "np.ndarray") -> tuple:
    w = params / max(params.sum(), 1.0)
    return _G_SQ_TOTAL * w, _SIGMA_SQ_TOTAL * w


def _act_bits(cfg: ModelConfig, seq_len: int, act_bytes: int) -> float:
    return seq_len * cfg.d_model * 8 * act_bytes


def _transformer_layer_flops(cfg: ModelConfig, kinds: tuple, seq: int) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    f = 0.0
    for kind in kinds:
        if kind in ("attn", "attn_nc"):
            proj = 2 * seq * d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            causal = 0.5 if (kind == "attn" and cfg.causal) else 1.0
            scores = 2 * seq * seq * cfg.n_heads * hd * 2 * causal
            f += proj + scores
        elif kind == "xattn":
            proj = (
                2 * seq * d * hd * cfg.n_heads * 2
                + 2 * cfg.encoder_seq * d * hd * cfg.n_kv_heads * 2
            )
            f += proj + 2 * seq * cfg.encoder_seq * cfg.n_heads * hd * 2
        elif kind == "ffn":
            f += 2 * seq * 3 * d * cfg.d_ff
        elif kind == "ffn_gelu":
            f += 2 * seq * 2 * d * cfg.d_ff
        elif kind == "moe":
            f += 2 * seq * 3 * d * cfg.resolved_d_ff_expert * cfg.top_k
            f += 2 * seq * d * cfg.n_experts          # router
        elif kind == "mamba":
            d_in = cfg.ssm_expand * d
            n = cfg.ssm_state_dim
            f += 2 * seq * (2 * d * d_in + d_in * d_in + d_in * 2 * n + d_in * d)
            f += seq * d_in * n * 6                   # selective scan
        elif kind == "mlstm":
            d_in = 2 * d
            hdm = d_in // cfg.n_heads
            f += 2 * seq * (2 * d * d_in + 3 * d_in * d_in + d_in * d)
            f += seq * cfg.n_heads * hdm * hdm * 4    # C update + read
        elif kind == "slstm":
            f += 2 * seq * (4 * d * d + d * (d // cfg.n_heads) * 4)
            f += 2 * seq * (d * (4 * d) // 3) * 2
    return f


def _transformer_layer_params(cfg: ModelConfig, kinds: tuple) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = 0.0
    for kind in kinds:
        if kind in ("attn", "attn_nc", "xattn"):
            p += d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        elif kind == "ffn":
            p += 3 * d * cfg.d_ff
        elif kind == "ffn_gelu":
            p += 2 * d * cfg.d_ff
        elif kind == "moe":
            p += 3 * d * cfg.resolved_d_ff_expert * cfg.n_experts + d * cfg.n_experts
        elif kind == "mamba":
            d_in = cfg.ssm_expand * d
            p += (
                2 * d * d_in + d_in * d_in
                + d_in * (2 * cfg.ssm_state_dim + 1) + d_in * d
            )
        elif kind == "mlstm":
            d_in = 2 * d
            p += 2 * d * d_in + 3 * d_in * d_in + d_in * d
        elif kind == "slstm":
            p += 4 * d * d + d * (d // cfg.n_heads) * 4 + 2 * d * (4 * d) // 3
    return p


def model_profile(
    cfg: ModelConfig, *, seq_len: int = 128,
    act_bytes: int = 4, param_bytes: int = 4
) -> LayerProfile:
    """Build the per-cut-point profile the HASFL optimizer consumes."""
    if cfg.family == CNN:
        return _cnn_profile(cfg, act_bytes, param_bytes)

    program, repeats = layer_program(cfg)
    layers = []
    if cfg.is_enc_dec:
        enc_prog, enc_reps = 1 * [("attn_nc", "ffn_gelu")], cfg.n_encoder_layers
        for _ in range(enc_reps):
            layers.append(("enc", enc_prog[0]))
    for _ in range(repeats):
        for kinds in program:
            layers.append(("dec", kinds))

    n = len(layers)
    flops = np.zeros(n)
    params = np.zeros(n)
    psi = np.zeros(n)
    for idx, (side, kinds) in enumerate(layers):
        seq = cfg.encoder_seq if side == "enc" else seq_len
        flops[idx] = _transformer_layer_flops(cfg, kinds, seq)
        params[idx] = _transformer_layer_params(cfg, kinds)
        psi[idx] = _act_bits(cfg, seq, act_bytes)
        if side == "enc" and idx == cfg.n_encoder_layers - 1:
            # cutting at the enc/dec boundary ships encoder output once
            psi[idx] = _act_bits(cfg, cfg.encoder_seq, act_bytes)

    # embedding params on the first layer; head on the last
    params[0] += cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        params[-1] += cfg.vocab_size * cfg.d_model
        flops[-1] += 2 * seq_len * cfg.d_model * cfg.vocab_size

    rho = np.cumsum(flops)
    bwd = np.cumsum(flops * BWD_MULT)
    delta = np.cumsum(params) * 8 * param_bytes
    g_sq, sigma_sq = _assumption2_priors(params)
    return LayerProfile(
        rho=rho, bwd=bwd, psi=psi, chi=psi.copy(), delta=delta, params=params,
        g_sq=g_sq, sigma_sq=sigma_sq)


def _cnn_profile(cfg: ModelConfig, act_bytes: int, param_bytes: int) -> LayerProfile:
    from repro_torch.models.cnn import _pool_after
    flops, params, psi = [], [], []
    spatial = cfg.image_size
    cin = 3
    for i, c in enumerate(cfg.conv_channels):
        stride2 = cfg.residual and i > 0 and c != cin
        if stride2:
            spatial = max(1, spatial // 2)
        f = 2 * 9 * cin * c * spatial * spatial
        p = 9 * cin * c + c
        if cfg.residual and stride2:
            f += 2 * cin * c * spatial * spatial
            p += 9 * cin * c + c  # 3x3 projection conv
        cin = c
        if _pool_after(cfg, i + 1):
            spatial = max(1, spatial // 2)
        flops.append(f)
        params.append(p)
        psi.append(c * spatial * spatial * 8 * act_bytes)
    flat = cin if cfg.residual else cin * spatial * spatial
    prev = flat
    for fdim in list(cfg.fc_dims) + [cfg.n_classes]:
        flops.append(2 * prev * fdim)
        params.append(prev * fdim + fdim)
        psi.append(fdim * 8 * act_bytes)
        prev = fdim
    flops, params, psi = map(np.asarray, (flops, params, psi))
    g_sq, sigma_sq = _assumption2_priors(params.astype(float))
    return LayerProfile(
        rho=np.cumsum(flops), bwd=np.cumsum(flops * BWD_MULT),
        psi=psi.astype(float), chi=psi.astype(float),
        delta=np.cumsum(params) * 8.0 * param_bytes, params=params.astype(float),
        g_sq=g_sq, sigma_sq=sigma_sq)
