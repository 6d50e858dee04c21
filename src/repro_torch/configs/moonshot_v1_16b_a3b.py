"""moonshot-v1-16b-a3b [moe] — kimi/moonlight family, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (kv=16) expert
d_ff=1408 vocab=163840."""

from repro_torch.models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=163_840,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408),
        subquadratic=False,
    )
