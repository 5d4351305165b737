"""smollm-135m: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M] -- llama-arch small, tied embeddings."""
import dataclasses

from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
        d_ff=1536, vocab_size=49152, tie_embeddings=True, remat_group=6)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="smollm-135m-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
