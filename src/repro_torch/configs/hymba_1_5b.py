"""hymba-1.5b: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 -- parallel attention + mamba heads per layer
[arXiv:2411.13676].

Hybrid mixer: each layer computes attention and SSD on the same input and
averages the per-branch-normalised outputs.  Attention uses a 1k sliding
window.
"""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001, mixer="hybrid",
        window=1024, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
        ssm_chunk=256, remat_group=8)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="hymba-1.5b-smoke", num_layers=2, d_model=64,
        num_heads=5, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=128, window=32, ssm_state=8, ssm_head_dim=16,
        ssm_chunk=16)
