"""Butcher tableaus of the explicit (embedded) Runge-Kutta solvers.

A copy of ``repro/core/tableaus.py`` with plain Python floats (importing
the reference would import JAX). Field semantics:

  * ``a``  — (s, s) strictly-lower-triangular stage coefficients, one
    tuple per row;
  * ``b``  — (s,) solution weights of order ``order``;
  * ``b_err`` — (s,) b - b_hat against the embedded lower-order solution;
    ``None`` for fixed-step methods;
  * ``c``  — (s,) stage times;
  * ``fsal`` — first-same-as-last: stage 0 of the next step equals the
    last stage of the accepted step;
  * ``b_mid`` — optional dense-output midpoint weights.

``tests/test_torch_tableaus.py`` pins every entry and alias equal to the
reference's, coefficient for coefficient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "Tableau",
    "EULER",
    "MIDPOINT",
    "HEUN2",
    "RK4",
    "HEUN_EULER",
    "BOGACKI_SHAMPINE",
    "DOPRI5",
    "get_tableau",
    "FIXED_SOLVERS",
    "ADAPTIVE_SOLVERS",
]


@dataclasses.dataclass(frozen=True)
class Tableau:
    """Immutable Butcher tableau of one explicit RK method; ``adaptive``
    is derived from the presence of embedded-error weights ``b_err``."""
    name: str
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    b_err: Optional[Tuple[float, ...]] = None
    fsal: bool = False
    b_mid: Optional[Tuple[float, ...]] = None

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def adaptive(self) -> bool:
        return self.b_err is not None

    def validate(self) -> None:
        """Consistency checks: explicit, row sums = c, sum(b) = 1,
        sum(b_err) = 0, sum(b_mid) = 1/2. Raises ValueError naming the
        violation (tableaus may come from user code)."""
        s = self.stages
        if len(self.a) != s or len(self.c) != s:
            raise ValueError(
                f"{self.name}: {len(self.a)} a-rows and {len(self.c)} "
                f"stage times for {s} stages")
        for i, row in enumerate(self.a):
            if len(row) > i and any(abs(x) > 1e-12 for x in row[i:]):
                raise ValueError(f"{self.name}: tableau not explicit "
                                 "(nonzero entries on/above the diagonal)")
            if abs(sum(row) - self.c[i]) > 1e-12:
                raise ValueError(f"{self.name}: row sums != c")
        if abs(sum(self.b) - 1.0) >= 1e-12:
            raise ValueError(f"{self.name}: sum(b) != 1")
        if self.b_err is not None and abs(sum(self.b_err)) >= 1e-12:
            raise ValueError(f"{self.name}: sum(b_err) != 0")
        if self.b_mid is not None:
            if len(self.b_mid) != s:
                raise ValueError(
                    f"{self.name}: b_mid has {len(self.b_mid)} weights, "
                    f"expected {s}")
            if abs(sum(self.b_mid) - 0.5) >= 1e-12:
                raise ValueError(f"{self.name}: sum(b_mid) != 1/2")


# ----------------------------------------------------------------------------
# Fixed-step methods
# ----------------------------------------------------------------------------

EULER = Tableau(
    name="euler",
    a=((),),
    b=(1.0,),
    c=(0.0,),
    order=1,
)

MIDPOINT = Tableau(
    name="midpoint",
    a=((), (0.5,)),
    b=(0.0, 1.0),
    c=(0.0, 0.5),
    order=2,
)

# Explicit trapezoid / Heun's 2nd-order method — this is the paper's "RK2".
HEUN2 = Tableau(
    name="rk2",
    a=((), (1.0,)),
    b=(0.5, 0.5),
    c=(0.0, 1.0),
    order=2,
)

RK4 = Tableau(
    name="rk4",
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
)

# ----------------------------------------------------------------------------
# Adaptive embedded pairs
# ----------------------------------------------------------------------------

# Heun-Euler 1(2): advance with Heun (order 2), error against Euler (order 1).
# The paper trains NODE18 with this solver (Appendix D, rtol=atol=1e-2).
HEUN_EULER = Tableau(
    name="heun_euler",
    a=((), (1.0,)),
    b=(0.5, 0.5),
    b_err=(0.5 - 1.0, 0.5 - 0.0),  # b - b_hat with b_hat = (1, 0) (Euler)
    c=(0.0, 1.0),
    order=2,
)

# Bogacki-Shampine 2(3) — the paper's "RK23". FSAL.
BOGACKI_SHAMPINE = Tableau(
    name="bosh3",
    a=(
        (),
        (0.5,),
        (0.0, 0.75),
        (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0),
    ),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0),
    b_err=(
        2.0 / 9.0 - 7.0 / 24.0,
        1.0 / 3.0 - 1.0 / 4.0,
        4.0 / 9.0 - 1.0 / 3.0,
        0.0 - 1.0 / 8.0,
    ),
    c=(0.0, 0.5, 0.75, 1.0),
    order=3,
    fsal=True,
)

# Dormand-Prince 4(5) — the paper's "RK45" / "Dopri5". FSAL.
DOPRI5 = Tableau(
    name="dopri5",
    a=(
        (),
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
        (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
        (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
         -5103.0 / 18656.0),
        (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
         11.0 / 84.0),
    ),
    b=(35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
       11.0 / 84.0, 0.0),
    b_err=(
        35.0 / 384.0 - 5179.0 / 57600.0,
        0.0,
        500.0 / 1113.0 - 7571.0 / 16695.0,
        125.0 / 192.0 - 393.0 / 640.0,
        -2187.0 / 6784.0 + 92097.0 / 339200.0,
        11.0 / 84.0 - 187.0 / 2100.0,
        0.0 - 1.0 / 40.0,
    ),
    c=(0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0),
    order=5,
    fsal=True,
    # Shampine's dense-output midpoint: z(t + h/2) = z + h·Σ b_mid_i k_i
    # (the classic coefficients used by dopri5 dense output; feeds the
    # 4th-order quartic fit of stepper.interp_fit)
    b_mid=(
        6025192743.0 / 30085553152.0 / 2.0,
        0.0,
        51252292925.0 / 65400821598.0 / 2.0,
        -2691868925.0 / 45128329728.0 / 2.0,
        187940372067.0 / 1594534317056.0 / 2.0,
        -1776094331.0 / 19743644256.0 / 2.0,
        11237099.0 / 235043384.0 / 2.0,
    ),
)


_REGISTRY = {
    t.name: t
    for t in (EULER, MIDPOINT, HEUN2, RK4, HEUN_EULER, BOGACKI_SHAMPINE, DOPRI5)
}
# aliases matching the paper's naming
_REGISTRY["rk23"] = BOGACKI_SHAMPINE
_REGISTRY["bogacki_shampine"] = BOGACKI_SHAMPINE
_REGISTRY["rk45"] = DOPRI5
_REGISTRY["heuneuler"] = HEUN_EULER

FIXED_SOLVERS = tuple(sorted(
    n for n, t in _REGISTRY.items() if not t.adaptive))
ADAPTIVE_SOLVERS = tuple(sorted(
    n for n, t in _REGISTRY.items() if t.adaptive))


def get_tableau(name: str) -> Tableau:
    """Look up a registered tableau by case/dash-insensitive name.

    Accepted names are exactly ``FIXED_SOLVERS`` + ``ADAPTIVE_SOLVERS``
    (both derived from the registry, aliases included).  Raises KeyError
    enumerating them for unknown names.
    """
    key = name.lower().replace("-", "_")
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown solver {name!r}; fixed-step: "
            f"{', '.join(FIXED_SOLVERS)}; adaptive: "
            f"{', '.join(ADAPTIVE_SOLVERS)}")
    return _REGISTRY[key]


for _t in (EULER, MIDPOINT, HEUN2, RK4, HEUN_EULER, BOGACKI_SHAMPINE, DOPRI5):
    _t.validate()
