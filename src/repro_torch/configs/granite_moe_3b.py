"""granite-moe-3b-a800m: 32L d_model=1536 24H (GQA kv=8) expert d_ff=512
vocab=49155, 40 experts top-8 [hf:ibm-granite granite-3.0 MoE family].

Every layer's FFN is a dropping top-8 mixture of 40 gated experts
(``models/moe.py``); embeddings are tied.
"""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        moe_experts=40, moe_topk=8, tie_embeddings=True, remat_group=8)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="granite-moe-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
        vocab_size=128, moe_experts=5, moe_topk=2,
        moe_capacity_factor=64.0)
