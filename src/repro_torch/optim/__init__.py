from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa: F401
from .compression import dequantize_int8, quantize_int8, topk_densify, topk_sparsify  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
