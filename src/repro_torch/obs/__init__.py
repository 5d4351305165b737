"""``repro_torch.obs`` -- the port's telemetry spine: metrics, tracing,
export.

Process-local observability the estimator and the serving engines report
through, with the reference's taxonomy and JSON schema
(``docs/OBSERVABILITY.md``):

    import repro_torch.obs as obs

    obs.enable()                      # default off; REPRO_OBS=1 also works
    with obs.trace_span("estimator.solve"):
        ...
    obs.inc("cache.hits")
    obs.record("engine.record_latency_seconds", dt)
    obs.snapshot()                    # -> dict (counters/gauges/histograms)

Disabled (the default) every helper is a no-op that allocates nothing, so
instrumented hot paths cost one bool check.  Values that refuse ``float``
concretisation (tensors of more than one element, batched tensors under
``torch.func.vmap``) are dropped, never captured.  ``bench_record``
serialises ``snapshot()`` plus seeds and an environment fingerprint into
the reference's schema-v1 ``BENCH_<name>.json`` artifact.

The reference's two profiler passthroughs carry PyTorch's wording here:
``xla_profile(logdir)`` is ``torch_profile(logdir)``, and every
``trace_span`` is a range on the timeline of a recording
``torch.profiler`` (its ``record_function=`` stands for the reference's
``xla=`` and changes nothing).  ``tracing.trace_range(name)`` is such a
range alone, with no span: the program's layer boundaries.
"""
from .export import (
    ROW_KEYS,
    SCHEMA_VERSION,
    bench_record,
    env_fingerprint,
    snapshot,
    validate_bench,
    write_bench_json,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    REGISTRY,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    histogram,
    inc,
    record,
    set_gauge,
)
from .tracing import Span, span_trees, torch_profile, trace_span
from . import metrics as _metrics, tracing as _tracing


def reset() -> None:
    """Clear every recorded metric and span (keeps the enabled flag)."""
    _metrics.reset()
    _tracing.reset()


__all__ = [
    "enable", "disable", "enabled", "reset",
    "counter", "gauge", "histogram", "inc", "record", "set_gauge",
    "Counter", "Gauge", "Histogram", "REGISTRY",
    "trace_span", "span_trees", "torch_profile", "Span",
    "snapshot", "env_fingerprint",
    "bench_record", "validate_bench", "write_bench_json",
    "SCHEMA_VERSION", "ROW_KEYS",
]
