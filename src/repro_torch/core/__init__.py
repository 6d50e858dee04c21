"""THAPI tracing core for the PyTorch port.

    from repro_torch.core import TraceConfig, Tracer, trace_session   # collection
    from repro_torch.core import TracedStep, kernel_span              # interception
    from repro_torch.core import train_step_span, data_next_span      # framework spans
    from repro_torch.core import traced_device_put, traced_device_get # §1.1 memcpy
    from repro_torch.core import MasterServer, ServeOptions, StreamClient    # streaming
    from repro_torch.core import AdaptiveController, WidenSamplingPolicy     # §6 adaptive
    from repro_torch.core import ClusterAdaptiveController, StragglerRankPolicy  # cluster scope
    from repro_torch.core.plugins.tally import tally_trace, render    # analysis
    python -m repro_torch.core.iprof run|tally|index|pretty|timeline|validate|combine|serve|top
"""

from .adaptive import (  # noqa: F401
    AdaptiveAction,
    AdaptiveController,
    AdaptivePolicy,
    ClusterAdaptiveController,
    ClusterPolicy,
    RankImbalanceAdvisoryPolicy,
    RingPressurePolicy,
    SickHostPolicy,
    StragglerRankPolicy,
    StreamCadencePolicy,
    ThresholdAdvisoryPolicy,
    WidenSamplingPolicy,
)
from .api_model import (  # noqa: F401
    TraceModel,
    builtin_models,
    builtin_trace_model,
    torchrt_model,
)
from .interception import (  # noqa: F401
    TracedStep,
    checkpoint_restore_span,
    checkpoint_save_span,
    data_next_span,
    decode_step_span,
    eval_step_span,
    kernel_span,
    optimizer_update_span,
    prefill_span,
    record_alloc,
    traced_device_get,
    traced_device_put,
    train_step_span,
)
from .stream import (  # noqa: F401
    MasterServer,
    ServeOptions,
    ServerRejected,
    SnapshotStreamer,
    StreamClient,
    live_snapshot,
    query_composite,
    query_groups,
    query_ranks,
    subscribe_composites,
)
from .tracer import TraceConfig, TraceHandle, Tracer, trace_session  # noqa: F401
