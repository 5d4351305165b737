"""starcoder2-15b: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152,
GQA + RoPE, non-gated (gelu) MLP [arXiv:2402.19173]."""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        d_ff=24576, vocab_size=49152, mlp_type="plain", act="gelu",
        remat_group=8)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="starcoder2-15b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
