"""Configuration of the language-model stack: model, shape, training and
mesh configs, and the model registry.

The port's own copy of the reference's ``config.py`` (which imports no
JAX, but the port imports nothing of the reference package).  Fields,
defaults and derived sizes are the reference's, so a config built here
describes the same model, cell or run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    mlp_type: str = "gated"      # gated | plain | none
    act: str = "silu"            # silu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None             # sliding-window attention
    causal: bool = True
    input_mode: str = "tokens"               # tokens | embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # layer mixer: attn | ssm | hybrid (parallel attn+ssm heads)
    mixer: str = "attn"

    # SSM (mamba2/SSD) parameters
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_capacity_factor: float = 1.25

    dtype: str = "bfloat16"
    # train_loss checkpoints each layer (recomputed in the backward pass);
    # remat_group > 0 adds a checkpoint around each group of that many
    # layers (two-level remat: one extra in-group forward).  The port
    # loops over layers in Python either way; unroll_layers drops the group
    # checkpoint, as the reference's unrolled stack does.
    remat: bool = True
    remat_group: int = 0
    unroll_layers: bool = False

    # Sharding policy of the reference's multi-device layouts; the port
    # runs on one card and ignores them.
    parallel_policy: str = "tp"
    seq_parallel: bool = False
    # True: one fused in_proj [z | x | B | C | dt] and one conv over
    # (x, B, C); False: per-stream projections and convs.
    ssm_fused_proj: bool = True
    kv_replicate: bool = False

    # embedding tables are padded to this multiple; pad logits are masked
    # to -1e30 in the decode heads.
    vocab_pad_multiple: int = 128

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        D, F, L = self.d_model, self.d_ff, self.num_layers
        n = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        per = 0
        if self.mixer in ("attn", "hybrid"):
            per += D * self.num_heads * self.hd * 2        # q, o
            per += D * self.num_kv_heads * self.hd * 2     # k, v
        if self.mixer in ("ssm", "hybrid"):
            gs = 2 * self.ssm_groups * self.ssm_state
            per += D * (2 * self.ssm_inner + gs + self.ssm_heads)
            per += self.ssm_inner * D
            per += (self.ssm_inner + gs) * self.ssm_conv
        if self.is_moe:
            per += D * self.moe_experts
            mults = 3 if self.mlp_type == "gated" else 2
            per += self.moe_experts * mults * D * F
        elif self.mlp_type != "none":
            mults = 3 if self.mlp_type == "gated" else 2
            per += mults * D * F
        per += 2 * D                                       # norms
        return n + L * per

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        mults = 3 if self.mlp_type == "gated" else 2
        dense_like = self.param_count() - (
            L * self.moe_experts * mults * D * F)
        return dense_like + L * self.moe_topk * mults * D * F


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell: what to run and at which shape."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPE_SUITE: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)


def shape_skip_reason(model: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Why a (model, shape) cell is skipped; None means it runs."""
    if model.is_encoder and shape.kind == "decode":
        return "encoder-only architecture has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = model.mixer in ("ssm", "hybrid") or model.window
        if not sub_quadratic:
            return ("pure full-attention architecture: 512k decode needs "
                    "sub-quadratic attention (see DESIGN.md S4)")
    return None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seq_len: int = 1024
    global_batch: int = 8
    microbatches: int = 1        # grad-accumulation steps
    # The sharded step: ZeRO-1 optimizer state over the data axes
    # (train.trainer.make_shardings); the compressed all-reduce is not
    # wired into the step, as in the reference.
    zero1: bool = True
    grad_compress: bool = False
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    pod: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod


_REGISTRY: dict = {}


def register_config(name: str, fn) -> None:
    _REGISTRY[name] = fn


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
