"""h2o-danube-1.8b: 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention [arXiv:2401.16818].

The 4096 window bounds the decode cache (a rolling window cache); the
head size is 2560 / 32 = 80."""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000, window=4096, remat_group=6)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="h2o-danube-1.8b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, window=32)
