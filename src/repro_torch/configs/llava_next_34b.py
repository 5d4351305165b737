"""llava-next-34b backbone: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 [hf:llava-hf/llava-v1.6, 34B-class backbone].

VLM: the anyres tiling vision frontend is a stub -- the batch carries
precomputed patch + text embeddings for training and prefill; decode
embeds tokens (the embedding table is present).
"""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20480, vocab_size=64000,
        input_mode="embeddings", remat_group=10)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="llava-next-34b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
