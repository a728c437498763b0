"""The reference's solves of a state whose leaves mix dtypes, for the port's
``tests/test_torch_mixed_dtype.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_mixed_dtype_reference.py

Runs ``repro.core.odeint`` on the state ``{"a": f32 (3,), "b": bf16 (2,)}``
(two rows of it under ``batch_axis=0``), dz/dt = −w z with w = 0.7, ts
[0, 0.5, 1], rtol 1e-3, atol 1e-4, for every gradient method × {solo,
batched} × {adaptive, fixed rk4 grid of 4 steps an interval,
``checkpoint_segments=2``, ``interpolate_ts``} that the reference takes,
and writes each case's outputs, counters, status and gradients (of the
sum of squares of every output, with respect to z0 and w) to
``tests/torch_mixed_dtype_reference.json``: the test holds the port to
these numbers without running the reference's solves (about two minutes
of CPU), and reruns two of them live. Rerun this script after changing
the cases.
"""

from __future__ import annotations

import json
import os

import numpy as np

A0 = np.array([1.0, -0.5, 2.0], np.float32)
B0 = np.array([0.3, -1.2], np.float32)
W = 0.7
TS = [0.0, 0.5, 1.0]
KW = dict(rtol=1e-3, atol=1e-4, max_steps=32)
MODES = {
    "adaptive": {},
    "fixed": dict(solver="rk4", steps_per_interval=4),
    "segmented": dict(checkpoint_segments=2),
    "interpolate_ts": dict(interpolate_ts=True),
}
METHODS = ("aca", "adjoint", "naive", "mali")
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_mixed_dtype_reference.json")


def takes(method: str, mode: str) -> bool:
    """The combinations the reference takes: mali only adaptive (its own
    ALF pair stepper, no segments, no dense output), segments only ACA."""
    if method == "mali":
        return mode == "adaptive"
    return mode != "segmented" or method == "aca"


CASES = [(m, batched, mode) for m in METHODS for batched in (False, True)
         for mode in MODES if takes(m, mode)]


def case_id(case) -> str:
    method, batched, mode = case
    return f"{method}-{'batched' if batched else 'solo'}-{mode}"


def inputs(batched: bool):
    """(a, b) numpy f32 initial leaves (b is cast to bf16 by each side)."""
    if batched:
        return np.stack([A0, 0.5 * A0]), np.stack([B0, 2.0 * B0])
    return A0, B0


def kwargs(case) -> dict:
    method, batched, mode = case
    kw = dict(KW, grad_method=method, **MODES[mode])
    if batched:
        kw["batch_axis"] = 0
    return kw


def reference(case) -> dict:
    """One case through the reference: outputs per leaf (as f32), counters,
    status and the gradients of sum(ys**2) with respect to a, b and w."""
    import jax
    import jax.numpy as jnp

    from repro.core import odeint

    def field(t, z, w):
        return {"a": -w * z["a"], "b": -w.astype(z["b"].dtype) * z["b"]}

    def loss(z, w):
        ys, st = odeint(field, z, jnp.asarray(TS, jnp.float32), (w,),
                        **kwargs(case))
        total = sum(jnp.sum(y.astype(jnp.float32) ** 2)
                    for y in ys.values())
        return total, (ys, st)

    a, b = inputs(case[1])
    z0 = {"a": jnp.asarray(a), "b": jnp.asarray(b).astype(jnp.bfloat16)}
    (_, (ys, st)), (gz, gw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(z0, jnp.float32(W))

    def f32(x):
        return np.asarray(x.astype(jnp.float32)).ravel().tolist()

    return {"dtypes": {k: str(v.dtype) for k, v in ys.items()},
            "grad_dtypes": {k: str(v.dtype) for k, v in gz.items()},
            "ys": {k: f32(v) for k, v in ys.items()},
            "n_steps": np.ravel(st.n_steps).tolist(),
            "n_trials": np.ravel(st.n_trials).tolist(),
            "status": np.ravel(st.status).tolist(),
            "grad": {"a": f32(gz["a"]), "b": f32(gz["b"]),
                     "w": float(gw)}}


def main() -> None:
    out = {}
    for case in CASES:
        out[case_id(case)] = reference(case)
        print(case_id(case), out[case_id(case)]["n_steps"], flush=True)
    with open(PATH, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
