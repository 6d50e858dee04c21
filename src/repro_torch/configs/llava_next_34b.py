"""llava-next-34b [vlm] — Yi-34B backbone; anyres tiling frontend STUBBED
(input_specs feeds precomputed patch embeddings, 2880 tokens = 24×24×5 tiles).
[hf:llava-hf/llava-v1.6-*; unverified] 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20_480,
        vocab_size=64_000,
        head_dim=128,
        rope_theta=5_000_000.0,
        vision_tokens=2880,
        remat="dots",
        subquadratic=False,
    )
