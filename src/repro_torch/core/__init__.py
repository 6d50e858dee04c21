"""THAPI tracing core for the PyTorch port.

    from repro_torch.core import TraceConfig, Tracer, trace_session   # collection
    from repro_torch.core import TracedStep, kernel_span              # interception
    from repro_torch.core import traced_device_put, traced_device_get # §1.1 memcpy
    from repro_torch.core.plugins.tally import tally_trace, render    # analysis
    python -m repro_torch.core.iprof run|tally|index|pretty|timeline|validate|combine
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
    record_alloc,
    traced_device_get,
    traced_device_put,
)
from .tracer import TraceConfig, TraceHandle, Tracer, trace_session  # noqa: F401
