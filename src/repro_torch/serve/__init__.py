"""repro_torch.serve — serving engines of the port.

* ``ServeEngine`` — batched prefill + decode LM serving, port of
  ``repro.serve.engine``.
* ``NodeServeEngine`` — continuous-batching NODE solve serving with
  per-request tolerance QoS, port of ``repro.serve.node_engine``.
"""

from .engine import ServeConfig, ServeEngine
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
    "ServeEngine",
    "ServeConfig",
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
