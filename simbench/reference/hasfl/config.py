"""The configuration types the frozen host plane reads: a frozen copy of
the port's ``config.py`` dataclasses (model widths, the edge devices, the
SFL settings), with the structure helper the CNN profile needs.  Nothing
here is imported from the program."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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
    def is_cnn(self) -> bool:
        return self.family == CNN

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




def _pool_after(cfg, conv_idx_1based: int) -> bool:
    if cfg.residual:
        return False
    if len(cfg.conv_channels) == 13:  # full VGG-16
        return conv_idx_1based in (2, 4, 7, 10, 13)
    return conv_idx_1based % 2 == 0
