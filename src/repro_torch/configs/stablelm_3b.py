"""stablelm-3b [dense]. [hf:stabilityai/stablelm-2-1_6b family; unverified]
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304. LayerNorm per stablelm-2."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=6912,
        vocab_size=50_304,
        norm="layernorm",
        subquadratic=False,
    )
