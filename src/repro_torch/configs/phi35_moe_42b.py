"""phi3.5-moe-42b-a6.6b: 32L d_model=4096 32H (GQA kv=8) expert d_ff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=6400, vocab_size=32064,
        moe_experts=16, moe_topk=2, remat_group=8)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="phi3.5-moe-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128, moe_experts=4, moe_topk=2,
        moe_capacity_factor=64.0)
