"""THAPI tracing core for the PyTorch port.

    from repro_torch.core import TraceConfig, Tracer, trace_session   # collection
    from repro_torch.core import TracedStep, kernel_span              # interception
    from repro_torch.core.plugins.tally import tally_trace, render    # analysis
"""

from .api_model import (  # noqa: F401
    TraceModel,
    builtin_models,
    builtin_trace_model,
    torchrt_model,
)
from .interception import (  # noqa: F401
    TracedStep,
    decode_step_span,
    kernel_span,
    prefill_span,
)
from .tracer import TraceConfig, TraceHandle, Tracer, trace_session  # noqa: F401
