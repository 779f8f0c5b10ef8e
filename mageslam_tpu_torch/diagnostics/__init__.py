"""Diagnostics: determinism tracing, metric channels, structured inspection
(port of mageslam_tpu/diagnostics).

The reference's observability stack (SURVEY §5.1/§5.5):
  - arcana `determinator` (analysis/determinator.h:16-61) → `trace.Determinator`:
    CRC32 hashes of pipeline intermediates, recordable and replay-comparable
  - `FIRE_OBJECT_TRACE` channels (analysis/object_trace.h) → `trace.MetricChannels`
  - SkeletonKey/SkeletonLogger (Debugging/) → `introspect.Introspection`:
    leveled structured dumps and an observer fan-out
  - arcana xray (analysis/xray.h:28-43) + DataFlow (Analysis/DataFlow.h:14-66)
    → `xray.XRay`: full per-stage input/output dumps as JSON, with
    `diff_dumps` for the offline diff

A `SlamSession` takes them as `metrics=`, `introspection=`, `determinator=`
and `xray=` (or `attach_xray`); with none attached its hooks read nothing
from the device. The hashes and the JSON captures are the JAX package's for
the same data, so the two packages' streams and captures compare directly.
"""

from .introspect import Introspection, LogLevel  # noqa: F401
from .xray import XRay, diff_dumps  # noqa: F401
# after the submodule `xray`, so that the name is the decorator
from .trace import Determinator, MetricChannels, hash_tree, xray  # noqa: F401
