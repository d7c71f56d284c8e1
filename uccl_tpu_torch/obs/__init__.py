"""uccl_tpu_torch.obs — event tracing and the telemetry registry.

Port of ``uccl_tpu/obs`` (jax-free there too): the counter / gauge /
histogram registry (:mod:`.counters`), the ring-buffered host event tracer
(:mod:`.tracer`), the cross-process trace context (:mod:`.context`), the
Prometheus-text / JSON / Chrome-trace export surfaces (:mod:`.export`,
:mod:`.chrome_trace`), the flight recorder (:mod:`.flight`), the SLO
burn-rate monitors over the histogram families (:mod:`.slo`) and the fleet
federation of N workers' ``/metrics`` (:mod:`.aggregate`), under the JAX
package's names.

Everything is a no-op (one bool check) until ``obs.enable_tracing()`` /
``--trace-out`` turns the tracer on; counters are always live.
"""

from uccl_tpu_torch.obs.counters import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, REGISTRY, CounterFamily, GaugeFamily, HistogramFamily, Registry,
    bucket_width, counter, escape_label_value, gauge, histogram, histogram_quantile, log_buckets,
    sanitize_name,
)
from uccl_tpu_torch.obs.context import (  # noqa: F401
    TraceContext, estimate_clock_offset, flow_id, new_context,
)
from uccl_tpu_torch.obs.tracer import (  # noqa: F401
    Event, Tracer, begin, complete, end, flow_end, flow_start, get_tracer, instant,
    set_clock_offset, span,
)
from uccl_tpu_torch.obs.tracer import enable as enable_tracing  # noqa: F401
from uccl_tpu_torch.obs.tracer import disable as disable_tracing  # noqa: F401
from uccl_tpu_torch.obs.tracer import enabled as tracing_enabled  # noqa: F401
from uccl_tpu_torch.obs.export import (  # noqa: F401
    SCHEMA_VERSION, MetricsServer, add_cli_args, dump_at_exit, dump_from_args, json_snapshot,
    prometheus_text, setup_from_args, write_metrics, write_trace,
)
from uccl_tpu_torch.obs.chrome_trace import to_chrome_trace  # noqa: F401
from uccl_tpu_torch.obs.flight import (  # noqa: F401
    TRIGGERS, FlightRecorder, install_excepthook, record_exception,
)
from uccl_tpu_torch.obs.flight import enable as enable_flight  # noqa: F401
from uccl_tpu_torch.obs.flight import disable as disable_flight  # noqa: F401
from uccl_tpu_torch.obs.flight import enabled as flight_enabled  # noqa: F401
from uccl_tpu_torch.obs.flight import get_recorder as get_flight  # noqa: F401
from uccl_tpu_torch.obs.flight import register_provider as flight_provider  # noqa: F401
from uccl_tpu_torch.obs.flight import trigger as flight_trigger  # noqa: F401
from uccl_tpu_torch.obs.flight import unregister_provider as flight_unregister  # noqa: F401
from uccl_tpu_torch.obs.slo import (  # noqa: F401
    Alert, BurnRateMonitor, Objective, serving_objectives,
)
