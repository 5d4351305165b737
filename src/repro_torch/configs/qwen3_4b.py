"""qwen3-4b: 36L d_model=2560 32H (GQA kv=8) head_dim=128 d_ff=9728
vocab=151936, qk_norm [hf:Qwen/Qwen3 family]."""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=9728, vocab_size=151936, qk_norm=True,
        rope_theta=1e6, remat_group=6)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen3-4b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128)
