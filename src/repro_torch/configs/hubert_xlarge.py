"""hubert-xlarge: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504.

Encoder-only audio backbone [arXiv:2106.07447].  The convolutional
waveform frontend is a stub: the batch carries precomputed frame
embeddings (B, S, d_model); training is masked-frame prediction over the
504-unit codebook.  Attention is bidirectional, head size 1280 / 16 = 80.
No decode step exists.
"""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        d_ff=5120, vocab_size=504, mlp_type="plain", act="gelu",
        causal=False, input_mode="embeddings", mixer="attn", remat_group=8)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="hubert-xlarge-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128)
