"""repro_torch.data — the paper's synthetic datasets on the port.

Port of ``repro.data``: spiral classification (Table 2/3/6/7), irregular
time series (Table 4) and three-body trajectories (Table 5). The numpy
draws are the reference's, so the same seed gives the same bits; the
results are tensors on ``device``; ``TokenPipeline`` makes the LM
training batches.
"""

from .synthetic import TokenPipeline, spiral_classification
from .threebody import simulate_three_body, three_body_rhs
from .timeseries import irregular_series_batch, merged_time_grid

__all__ = [
    "TokenPipeline", "spiral_classification",
    "irregular_series_batch", "merged_time_grid",
    "simulate_three_body", "three_body_rhs",
]
