"""The port's AdamW and schedules (``repro_torch.optim``) against the
reference's ``repro.optim`` on the same numpy inputs, within rtol 1e-6
(the same f32 arithmetic in the same order; CPU runs agree bitwise).

* Each schedule (constant, step_decay, exponential_decay, cosine_warmup)
  at steps 0..12.
* AdamW over 5 steps on a dict of 1-D and 2-D leaves, with and without
  decoupled decay (default mask: 2-D leaves only; and a custom mask),
  under each schedule: parameters and both moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim.adamw import apply_updates as j_apply
from repro_torch import optim as topt

RTOL = 1e-6
SCHEDULES = {
    "constant": (lambda m: m.constant(3e-3)),
    "step_decay": (lambda m: m.step_decay(0.1, [2, 4, 9], 0.3)),
    "exponential_decay": (lambda m: m.exponential_decay(0.05, 0.97)),
    "cosine_warmup": (lambda m: m.cosine_warmup(1e-2, 3, 10)),
}


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= RTOL * scale, (a, b)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    sj, st = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    a = [float(sj(jnp.int32(i))) for i in range(13)]
    b = [float(st(torch.tensor(i, dtype=torch.int32))) for i in range(13)]
    _close(b, a)
    assert st(torch.tensor(0, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("mask", [None, "bias_only"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_adamw_matches_reference(name, weight_decay, mask):
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32),
         "nested": {"u": rng.standard_normal((2, 2)).astype(np.float32)}}
    if mask is None:
        mj = mt = None
    else:
        mj = lambda q: jax.tree.map(lambda x: x.ndim == 1, q)  # noqa: E731
        mt = lambda q: {"w": False, "b": True,  # noqa: E731
                        "nested": {"u": False}}
    jo = jopt.adamw(SCHEDULES[name](jopt), weight_decay=weight_decay,
                    mask=mj)
    to = topt.adamw(SCHEDULES[name](topt), weight_decay=weight_decay,
                    mask=mt)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {"w": torch.tensor(p["w"]), "b": torch.tensor(p["b"]),
          "nested": {"u": torch.tensor(p["nested"]["u"])}}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p)
        u, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = j_apply(jp, u)
        gt = {"w": torch.tensor(g["w"]), "b": torch.tensor(g["b"]),
              "nested": {"u": torch.tensor(g["nested"]["u"])}}
        u2, ts = to.update(gt, ts, tp)
        tp = topt.apply_updates(tp, u2)
    assert int(ts.step) == int(js.step) == 5
    for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for key in ("w", "b"):
            _close(tree_t[key].numpy(), tree_j[key])
        _close(tree_t["nested"]["u"].numpy(), tree_j["nested"]["u"])
    assert ts.mu["w"].dtype == torch.float32


def test_adamw_on_a_single_tensor_keeps_requires_grad():
    """The three-body mass fit's form: one leaf that takes a gradient."""
    opt = topt.adamw(topt.constant(0.05))
    log_m = torch.zeros(3, requires_grad=True)
    st = opt.init(log_m)
    up, st = opt.update(torch.tensor([1.0, -2.0, 0.0]), st, log_m)
    new = topt.apply_updates(log_m, up)
    assert new.requires_grad and new.is_leaf
    np.testing.assert_allclose(new.detach().numpy(), [-0.05, 0.05, 0.0],
                               rtol=1e-5)
