"""``repro_torch.benchmarks.sharded_solve`` in quick mode at ranks (1, 2):
each rung spawned fresh on gloo ranks, its trials gate (per-row trial
counts identical on every rung), rows and headline keys, each naming the
device. The 3x speedup gate needs the 8-rank rung and is measured outside
tier-1 (``PERF.md``). On the cards the ladder stops at their count.
"""

import json

import pytest
import torch

from repro_torch.benchmarks import sharded_solve


def test_quick_ladder_holds_the_trials_gate(capsys):
    rungs = sharded_solve.run(quick=True, device="cpu", ranks=(1, 2),
                              iters=1)
    assert set(rungs) == {1, 2}
    trials = rungs[1]["trials"]
    assert len(trials) == sharded_solve.B
    assert rungs[2]["trials"] == trials
    # heavy-tailed stiffness: the top row takes many times the median's
    assert max(trials) > 10 * sorted(trials)[len(trials) // 2]
    # each rank's straggler is the largest count of its half of the rows
    half = sharded_solve.B // 2
    assert rungs[2]["rank_straggler_trials"] == [max(trials[:half]),
                                                 max(trials[half:])]
    assert rungs[1]["ys_sum"] == rungs[2]["ys_sum"]
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("sharded_solve/")]
    for row in ("t_ms/1dev", "t_ms/2dev", "speedup/2dev",
                "straggler_trials/2dev", "ms_per_trial/2dev"):
        assert any(ln.startswith(f"sharded_solve/cpu/{row},") for ln in rows)
    assert all(ln.startswith("sharded_solve/cpu/") for ln in rows)
    head = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    assert head["bench"] == "sharded_solve"
    assert head["metrics"]["device"] == "cpu"
    assert {"batch", "dim", "t_ms_1dev", "speedup_2dev",
            "straggler_trials"} <= set(head["metrics"])


def test_card_ladder_stops_at_the_card_count(monkeypatch):
    """NCCL takes one rank a card: the default ladder on the cards stops
    at their count, a rung above it is refused naming the count, and no
    card at all is refused (gloo ranks are asked for with 'cpu')."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sharded_solve.ladder_for("cuda") == (1,)
    with pytest.raises(ValueError, match="this machine has 1"):
        sharded_solve.ladder_for("cuda", (1, 2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert sharded_solve.ladder_for("cuda") == (1, 2, 4)
    assert sharded_solve.ladder_for("cpu") == (1, 2, 4, 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded_solve.ladder_for("cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        sharded_solve.ladder_for("mps")
