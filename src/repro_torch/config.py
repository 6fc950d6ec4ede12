"""Configuration system for the PyTorch port (a copy of `repro.config`).

Everything is a frozen dataclass so configs are hashable (usable as jit
static args) and cheap to copy via `dataclasses.replace`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Architecture families.
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
AUDIO = "audio"
VLM = "vlm"
CNN = "cnn"


@dataclass(frozen=True)
class ModelConfig:
    """A layered model definition.

    A model is a stack of ``n_layers`` blocks; HASFL cut points are block
    boundaries (cut ``c`` means blocks ``0..c-1`` are client-side).
    """

    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention details -------------------------------------------------
    head_dim: int = 0                    # 0 -> d_model // n_heads
    qk_norm: bool = False                # qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    sliding_window: int = 0              # 0 = full attention
    causal: bool = True
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0                   # 0 = dense FFN
    top_k: int = 0
    d_ff_expert: int = 0                 # 0 -> d_ff
    moe_every: int = 1                   # MoE block every k-th layer (1 = all)
    capacity_factor: float = 1.25
    # --- SSM / hybrid ------------------------------------------------------
    ssm_pattern: str = ""                # e.g. "mlstm*5,slstm" repeated; "" = n/a
    attn_every: int = 0                  # hybrid: attention layer every k layers
    ssm_state_dim: int = 16              # mamba state dim N
    ssm_conv_dim: int = 4                # mamba local conv width
    ssm_expand: int = 2                  # mamba expansion factor
    # --- encoder-decoder (audio) -------------------------------------------
    n_encoder_layers: int = 0            # >0 -> enc-dec model
    encoder_seq: int = 1500              # frontend-stub frames (whisper 30s)
    # --- VLM ---------------------------------------------------------------
    n_patches: int = 0                   # >0 -> vision-stub patch embeddings
    # --- CNN (paper-faithful CIFAR models) ---------------------------------
    conv_channels: Tuple[int, ...] = ()
    fc_dims: Tuple[int, ...] = ()
    image_size: int = 32
    n_classes: int = 10
    residual: bool = False               # ResNet-style skip connections
    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""                     # citation (paper / model card)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_ff_expert(self) -> int:
        return self.d_ff_expert or self.d_ff

    @property
    def is_enc_dec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_cnn(self) -> bool:
        return self.family == CNN

    @property
    def n_cut_points(self) -> int:
        """Number of valid cut layers for model splitting.

        For enc-dec models cut points span encoder then decoder blocks.
        """
        if self.is_cnn:
            # conv layers + fc layers + classifier head (all cuttable)
            return len(self.conv_channels) + len(self.fc_dims) + 1
        if self.is_enc_dec:
            return self.n_encoder_layers + self.n_layers
        return self.n_layers

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks + head)."""
        if self.is_cnn:
            return _cnn_param_count(self)
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * hd * n_q + 2 * d * hd * n_kv + hd * n_q * d
        if self.family == SSM:
            per_layer = _xlstm_block_params(self)
            blocks = per_layer * self.n_layers
        else:
            dense_ffn = 3 * d * self.d_ff  # SwiGLU (gate+up+down)
            if self.n_experts:
                moe_ffn = self.n_experts * 3 * d * self.resolved_d_ff_expert \
                    + d * self.n_experts
                n_moe = self.n_layers // self.moe_every
                n_dense = self.n_layers - n_moe
                ffns = n_moe * moe_ffn + n_dense * dense_ffn
            else:
                ffns = dense_ffn * self.n_layers
            mamba = 0
            if self.family == HYBRID and self.attn_every:
                # attention only on every attn_every-th layer; others mamba
                n_attn = self.n_layers // self.attn_every
                n_mamba = self.n_layers - n_attn
                mamba = n_mamba * _mamba_mixer_params(self)
                blocks = n_attn * attn + mamba + ffns + 2 * d * self.n_layers
            else:
                blocks = self.n_layers * attn + ffns + 2 * d * self.n_layers
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        enc = 0
        if self.is_enc_dec:
            # encoder blocks: self-attn + MLP; decoder adds cross-attn
            enc_block = attn + 2 * d * self.d_ff + 2 * d
            enc = self.n_encoder_layers * enc_block
            blocks += self.n_layers * attn  # cross attention in decoder
        return emb + blocks + head + enc

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe = self.n_layers // self.moe_every
        all_experts = n_moe * self.n_experts * 3 * d * self.resolved_d_ff_expert
        active = n_moe * self.top_k * 3 * d * self.resolved_d_ff_expert
        return full - all_experts + active


def _mamba_mixer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    return (2 * d * d_in            # in_proj (x and z)
            + d_in * cfg.ssm_conv_dim
            + d_in * (2 * n + 1)    # x -> B, C, dt
            + d_in * n              # A
            + d_in                  # D
            + d_in * d)             # out_proj


def _xlstm_block_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = 2 * d  # proj factor 2
    # qkv + igate/fgate + out + up/down proj
    return 3 * d_in * d_in + 2 * d_in + d_in * d + 2 * d * d_in + 2 * d


def _cnn_param_count(cfg: ModelConfig) -> int:
    total, cin = 0, 3
    for c in cfg.conv_channels:
        total += 3 * 3 * cin * c + c
        cin = c
    # assume final spatial 1x1 after pooling for fc sizing handled in model
    prev = cfg.conv_channels[-1] * (cfg.image_size // (2 ** min(5, len(cfg.conv_channels)))) ** 2
    prev = max(prev, cfg.conv_channels[-1])
    for f in cfg.fc_dims:
        total += prev * f + f
        prev = f
    total += prev * cfg.n_classes + cfg.n_classes
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# SFL / HASFL configuration (paper Table I defaults)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceProfile:
    """Resources of one edge device (paper notation)."""
    flops: float          # f_i, FLOP/s
    up_bw: float          # r_i^U, bit/s (to edge server)
    down_bw: float        # r_i^D, bit/s
    fed_up_bw: float      # r_{i,f}^U, bit/s (to fed server)
    fed_down_bw: float    # r_{i,f}^D
    memory: float         # v_{c,i}, bits


@dataclass(frozen=True)
class SFLConfig:
    n_devices: int = 20
    agg_interval: int = 15          # I
    lr: float = 5e-4                # gamma
    server_flops: float = 20e12     # f_s
    server_fed_bw: float = 370e6    # r_{s,f} / r_{f,s}, bit/s
    max_batch: int = 64             # B cap used by baselines / search
    clip_norm: float = 1.0          # per-client grad clip (0 = off); plain
                                    # SGD at the paper's gamma intermittently
                                    # diverges on small batches (DESIGN.md §2)
    epsilon: float = 0.1            # target avg squared grad norm
    # Assumption-2 constants (estimated online; these are priors)
    beta: float = 0.05
    theta_gap: float = 10.0         # f(w0) - f*
    bytes_per_param: int = 4        # fp32 sub-model exchange
    optimizer_state_mult: int = 2   # momentum -> 1, adam -> 2


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    steps: int = 100
    batch_size: int = 32
    seq_len: int = 128
    lr: float = 3e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"           # sgd | momentum | adam
    optimizer_dtype: str = "float32"  # adam moment dtype (bf16 for 400B)
    grad_accum: int = 1
    remat: bool = True
    eval_every: int = 50
    # checkpointing is not a TrainConfig concern: the simulation runs
    # own it declaratively (ExperimentSpec.checkpoint_every/-_dir)


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    data: int = 16
    model: int = 16
    pods: int = 2

    @property
    def shape(self):
        return (self.pods, self.data, self.model) if self.multi_pod else (self.data, self.model)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_chips(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n


# ---------------------------------------------------------------------------
# Hardware constants (NVIDIA H100 SXM target)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HWSpec:
    """One card's peak rates and memory, as the dry-run's roofline prices
    them (`launch/roofline.py`).

    ``link_bw`` is the slowest link that a mesh axis crosses: an axis of
    more cards than one node holds (``node_cards``) crosses the nodes'
    network, an axis within a node runs on NVLink (``nvlink_bw``).  Both
    production axes (16 cards) cross nodes of 8, so the roofline's
    collective term is priced at ``link_bw``."""

    peak_flops: float = 989e12     # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12        # HBM3 bytes/s per card
    link_bw: float = 50e9          # bytes/s each way: one 400 Gb/s NIC a card
    hbm_bytes: float = 80e9        # HBM3 capacity
    nvlink_bw: float = 450e9       # NVLink 4, bytes/s each way per card
    node_cards: int = 8            # cards one NVLink domain holds


# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 (1,979 with
# sparsity), 3.35 TB/s, 80 GB; NVLink 4 at 900 GB/s a card (450 each way)
# among the 8 cards of an HGX/DGX H100 node.  Between nodes, the DGX H100
# data sheet's eight single-port ConnectX-7 adapters at 400 Gb/s, one a
# card: 50 GB/s each way.
H100_SXM = HWSpec()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    # populate lazily so importing repro.config never imports model files
    if not _REGISTRY:
        from repro_torch import configs  # noqa: F401  (registers everything)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list:
    if not _REGISTRY:
        from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, d<=512)."""
    base = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=32 if cfg.resolved_head_dim else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.n_experts:
        # capacity_factor high enough that reduced smoke tests never drop
        # tokens (decode-vs-full equivalence holds exactly).
        base.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
                    d_ff_expert=min(cfg.resolved_d_ff_expert, 256),
                    capacity_factor=8.0)
    if cfg.is_enc_dec:
        base.update(n_encoder_layers=2, encoder_seq=16)
    if cfg.n_patches:
        base.update(n_patches=8)
    if cfg.attn_every:
        base.update(attn_every=2)
    if cfg.ssm_pattern:
        base.update(ssm_pattern="mlstm,slstm")  # keep both block kinds, period 2
    if cfg.is_cnn:
        base = dict(conv_channels=cfg.conv_channels[:3] and (8, 16, 16),
                    fc_dims=(32,), image_size=16, n_layers=0)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
