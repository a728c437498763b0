"""The port's segmented-memory and dense-output benchmarks
(``repro_torch.benchmarks.memory``, ``dense_eval``) and the latent-ODE
example's union-grid decode, against the reference's.

* ``memory``: the reference's row names, its gate (the bytes shrink over
  K = 1, 4, ⌈√N⌉ and end below the full buffer), and the slot arithmetic
  of the count: the state slots a buffer keeps, one state of 8 × 32 f32
  a slot.
* ``dense_eval``: the reference's rows, gates and counts: the same
  trials, the errors within 2× of the reference's either way (two
  orders of summation on one grid).
* the example: one training step runs, and the union-grid dense decode
  reads every sample within the reference's interpolated-vs-landed
  bound (5e-4 at rtol 1e-5) of its (B, T) landing decode.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import bench_dense_eval as jdense  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import dense_eval, memory  # noqa: E402
from repro_torch.benchmarks.timeseries import _f, gru_encode  # noqa: E402
from repro_torch.benchmarks.timeseries import init_params  # noqa: E402
from repro_torch.core import odeint  # noqa: E402
from repro_torch.data import irregular_series_batch  # noqa: E402
from repro_torch.examples import latent_timeseries  # noqa: E402

SLOT = 8 * 32 * 4        # one (8, 32) f32 state


@pytest.fixture(scope="module")
def memory_rows():
    return memory.run(quick=True, device="cpu")


def test_memory_rows_are_the_reference_names(memory_rows):
    out = memory_rows
    assert set(out) == {
        "memory_residual_bytes/full", "memory_residual_bytes/k1",
        "memory_residual_bytes/k4", "memory_residual_bytes/k14",
        "memory_horizon_bytes/full_64", "memory_horizon_bytes/auto_64",
        "memory_horizon_bytes/full_192", "memory_horizon_bytes/auto_192"}


def test_memory_gate_and_slots(memory_rows):
    """K = 1 keeps 1 snapshot + 1 k0 + 192 replay slots, K = 4 4 + 4 + 48,
    K = 14 14 + 14 + 14, the full buffer 192; the scalar grids and the
    loss's own saved tensors add the same few slots to each."""
    out = memory_rows
    full = out["memory_residual_bytes/full"]
    seq = [out[f"memory_residual_bytes/k{k}"] for k in (1, 4, 14)]
    assert seq == sorted(seq, reverse=True) and seq[-1] < full
    extra = full - 192 * SLOT
    assert 0 < extra < 8 * SLOT
    for k, slots in ((1, 194), (4, 56), (14, 42)):
        assert out[f"memory_residual_bytes/k{k}"] - slots * SLOT == extra
    assert out["memory_horizon_bytes/auto_192"] == seq[-1]
    # the full buffer grows like N, "auto" like sqrt(N)
    assert out["memory_horizon_bytes/full_192"] > \
        2.5 * out["memory_horizon_bytes/full_64"]
    assert out["memory_horizon_bytes/auto_192"] < \
        2.0 * out["memory_horizon_bytes/auto_64"]


def _rows(lines):
    return {ln.split(",")[0]: ln.split(",")[1] for ln in lines
            if not ln.startswith("{")}


def test_dense_eval_matches_reference():
    tcommon.ROWS.clear()
    out = dense_eval.run(device="cpu")
    port = _rows(tcommon.ROWS)
    jcommon.ROWS.clear()
    jdense.run()
    ref = _rows(jcommon.ROWS)
    assert set(port) == set(ref)
    for name in ("dense_eval_trials/landing",
                 "dense_eval_trials/interpolate_ts",
                 "dense_eval_reverse/trials"):
        assert int(port[name]) == int(ref[name]), name
    for name in ("dense_eval_err/landing", "dense_eval_err/interpolate_ts",
                 "dense_eval_reverse/roundtrip_gap"):
        assert 0.5 <= out[name] / float(ref[name]) <= 2.0, name
    assert out["dense_eval_trials/ratio"] >= 1.5
    assert out["dense_eval_err/interpolate_ts"] <= 2e-4


def test_latent_example_union_decode():
    assert latent_timeseries.main(["--device", "cpu", "--steps", "1"]) == 0
    p = init_params(torch.Generator().manual_seed(0), "cpu")
    d = irregular_series_batch(batch=8, n_obs=16, obs_dim=8, seed=123,
                               device="cpu")
    with torch.no_grad():
        for up in (False, True):
            pred, st = latent_timeseries.union_decode(p, d, rtol=1e-5,
                                                      use_pallas=up)
            z0 = gru_encode(p, d["ts"], d["ys"])
            ys, st_l = odeint(_f, z0, d["ts"], (p["f1"], p["f2"]),
                              solver="dopri5", rtol=1e-5, atol=1e-5,
                              max_steps=256, batch_axis=0, use_pallas=up)
            landed = ys.transpose(0, 1) @ p["dec"]
            assert pred.shape == landed.shape == d["ys"].shape
            assert float((pred - landed).abs().max()) <= 5e-4
            assert int(st.n_steps.sum()) < int(st_l.n_steps.sum())
