"""How far a batched adaptive solve on the card lands from the same solve
on CPU tensors, against the solve tolerance.

    python3 tests/torch_card_vs_cpu.py        # on a machine with the card

dz/dt = tanh(W z), W (64, 64), z0 (4, 64), Dopri5 at tolerance 1e-4 and
1e-6, ``batch_axis=0`` and each row solo, fused and plain paths: prints
max |ys(card) - ys(cpu)| beside the per-row steps and trials of both, and
the field's own error against float64 on each device. The grids follow
the error estimate, a difference of nearly equal stage sums, so the
fields' rounding moves the stepsizes and the outputs part by a fraction
of the tolerance (``tests/test_torch_cuda.py::test_batched_methods_on_
the_card`` bounds them by 10 x the tolerance).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.func import vmap  # noqa: E402

from repro_torch.core import odeint  # noqa: E402


def field(t, z, m):
    return torch.tanh(m @ z)


def solve(dev, w, z0, tol, use_pallas, batched):
    ys, st = odeint(field, torch.tensor(z0, device=dev), [0.0, 1.0],
                    (torch.tensor(w, device=dev),), solver="dopri5",
                    rtol=tol, atol=tol, use_pallas=use_pallas,
                    batch_axis=0 if batched else None)
    return ys.cpu().numpy(), st.n_steps.tolist(), st.n_trials.tolist()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 64)) * 0.2).astype(np.float32)
    z0 = rng.standard_normal((4, 64)).astype(np.float32)
    exact = np.tanh(np.einsum("ij,bj->bi", w.astype(np.float64),
                              z0.astype(np.float64)))
    for dev in ("cuda", "cpu"):
        m, z = torch.tensor(w, device=dev), torch.tensor(z0, device=dev)
        got = vmap(lambda zi: field(0.0, zi, m))(z).cpu().numpy()
        print(f"{dev}: field vs float64 {np.abs(got - exact).max():.3e}")
    for tol in (1e-4, 1e-6):
        for up in (True, False):
            card = solve("cuda", w, z0, tol, up, True)
            cpu = solve("cpu", w, z0, tol, up, True)
            print(f"tol {tol} use_pallas {up}: batched max |dys| "
                  f"{np.abs(card[0] - cpu[0]).max():.3e}, steps {card[1]} "
                  f"{cpu[1]}, trials {card[2]} {cpu[2]}")
            for b in range(z0.shape[0]):
                card = solve("cuda", w, z0[b], tol, up, False)
                cpu = solve("cpu", w, z0[b], tol, up, False)
                print(f"   row {b} solo: max |dys| "
                      f"{np.abs(card[0] - cpu[0]).max():.3e}, trials "
                      f"{card[2]} {cpu[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
