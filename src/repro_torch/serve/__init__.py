"""repro_torch.serve — the NODE solve server of the port.

``NodeServeEngine`` is continuous-batching NODE solve serving with
per-request tolerance QoS, port of ``repro.serve.node_engine``. The LM
``ServeEngine`` needs the LM stack and comes with slice G (ROADMAP
queue 1).
"""

from .node_engine import (
    STATUS_DEADLINE_MISS,
    NodeEngineConfig,
    NodeRequest,
    NodeServeEngine,
    RequestQueue,
    RequestResult,
    SimClock,
    augment_field,
    augment_state,
)

__all__ = [
    "STATUS_DEADLINE_MISS",
    "NodeEngineConfig",
    "NodeRequest",
    "NodeServeEngine",
    "RequestQueue",
    "RequestResult",
    "SimClock",
    "augment_field",
    "augment_state",
]
