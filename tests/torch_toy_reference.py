"""The reference's paper Fig. 6 numbers that ``chip_smoke.py`` holds the
port to (its ``TOY_REFERENCE_METHODS`` table).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_toy_reference.py

For the adjoint and naive columns at each (k, T) of the figure: the
relative gradient error from ``benchmarks/bench_toy_gradient.py``'s
``grad_rel_error`` and the accepted steps of the reference's forward
solve (Dopri5, rtol=atol=1e-5, max_steps=512), printed as a Python dict.
Needs JAX; runs on the CPU in about a minute.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_toy_gradient import grad_rel_error  # noqa: E402
from repro.core import odeint  # noqa: E402


def n_steps(method: str, k: float, t_end: float) -> int:
    _, stats = odeint(lambda t, z, kk: kk * z, jnp.float32(1.5),
                      jnp.array([0.0, t_end]), (jnp.float32(k),),
                      solver="dopri5", grad_method=method, rtol=1e-5,
                      atol=1e-5, max_steps=512)
    return int(stats.n_steps)


def main() -> None:
    print("TOY_REFERENCE_METHODS = {")
    for method in ("adjoint", "naive"):
        for k in (-2.0, 2.0):
            for t_end in (0.5, 1.0, 2.0, 3.0, 4.0):
                err = grad_rel_error(method, k, t_end)
                print(f"    ({method!r}, {k}, {t_end}): "
                      f"({err:.2e}, {n_steps(method, k, t_end)}),",
                      flush=True)
    print("}")


if __name__ == "__main__":
    main()
