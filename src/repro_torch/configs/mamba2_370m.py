"""mamba2-370m: 48L d_model=1024, attention-free SSD, vocab=50280,
ssm_state=128 [arXiv:2405.21060].

Every layer is the SSD mixer alone (no MLP); decode carries an O(1)
state per layer.
"""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=0, vocab_size=50280, mlp_type="none", mixer="ssm",
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        tie_embeddings=True, remat_group=8)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="mamba2-370m-smoke", num_layers=2, d_model=64,
        vocab_size=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
