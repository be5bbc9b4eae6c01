from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from adapt_tpu_torch.utils.tracing import (
    FlightRecorder,
    Tracer,
    global_flight_recorder,
    global_tracer,
)

__all__ = [
    "get_logger",
    "MetricsRegistry",
    "global_metrics",
    "FlightRecorder",
    "Tracer",
    "global_flight_recorder",
    "global_tracer",
]
