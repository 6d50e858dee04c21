"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf] 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000."""

from repro_torch.models.config import ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256_000,
        head_dim=256,
        mlp_type="geglu",
        norm="rmsnorm",
        tied_embeddings=True,
        rglru=RGLRUConfig(width=2560, d_conv=4, pattern=("rec", "rec", "attn"), local_window=2048),
        subquadratic=True,  # RG-LRU state + 2k local window → runs long_500k
    )
