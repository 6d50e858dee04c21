"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table config).
[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8) expert
d_ff=2048 vocab=163840, 384 experts top-8.

fsdp=True: at 1T params, weights+optimizer must shard over data×model
(ZeRO-3) to approach the 16 GB/chip HBM budget — see EXPERIMENTS §Dry-run."""

from repro_torch.models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=163_840,
        head_dim=128,
        moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048),
        fsdp=True,
        remat="dots",
        subquadratic=False,
    )
