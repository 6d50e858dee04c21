"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32_000,
        sliding_window=4096,
        subquadratic=True,  # SWA → O(window) decode, runs long_500k
    )
