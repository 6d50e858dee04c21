"""whisper-medium [audio] — enc-dec; conv frontend STUBBED (input_specs feeds
precomputed frame embeddings). [arXiv:2212.04356; unverified]
24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865; encoder 24L × 1500 frames."""

from repro_torch.models.config import EncDecConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51_865,
        mlp_type="gelu",
        norm="layernorm",
        tied_embeddings=True,
        encdec=EncDecConfig(enc_layers=24, enc_positions=1500),
        subquadratic=False,
    )
