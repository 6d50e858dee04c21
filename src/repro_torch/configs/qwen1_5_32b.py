"""qwen1.5-32b [dense] — QKV bias. [hf:Qwen/Qwen1.5-*; hf]
64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27_392,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        remat="dots",
        subquadratic=False,  # full attention → skip long_500k
    )
