"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified] 48L d_model=2048 vocab=50280 ssm_state=128."""

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=32,  # unused: attention-free
        num_kv_heads=32,
        d_ff=0,  # unused: no MLP sub-block in Mamba2
        vocab_size=50_280,
        head_dim=64,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256, n_groups=1),
        subquadratic=True,  # O(1) state → runs long_500k
    )
