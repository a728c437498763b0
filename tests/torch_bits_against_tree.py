"""Bit-for-bit comparison of one-dtype solves between two trees of the
port.

    PYTHONPATH=A/src python tests/torch_bits_against_tree.py save a.pt
    PYTHONPATH=B/src python tests/torch_bits_against_tree.py save b.pt
    python tests/torch_bits_against_tree.py compare a.pt b.pt

``save`` runs ``odeint`` on one f32, f64 or bf16 tensor and on one f32
pytree state under every gradient method × {solo, batch_axis=0} ×
{adaptive, fixed rk4, ``checkpoint_segments=3``, ``interpolate_ts``} ×
``use_pallas`` {False, True} that the port takes (on CPU tensors: the
kernels' plain versions), plus one ``odeint_dense`` read, and saves the
outputs, the gradients with respect to z0 and w and the ``SolveStats``.
A configuration the tree refuses is saved as "error". ``compare`` lists
the configurations whose tensors differ in any bit.
"""

import sys

import numpy as np
import torch

W = 0.7
TS = [0.0, 0.4, 1.0]


def f_tensor(t, z, w):
    return -w.to(z.dtype) * z + 0.1 * torch.sin(t) * torch.tanh(z)


def f_tree(t, z, w):
    return {"a": f_tensor(t, z["a"], w), "b": f_tensor(t, z["b"], w)}


def configurations():
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for tree in (False, True):
            if dtype != torch.float32 and tree:
                continue
            for method in ("aca", "adjoint", "naive", "mali"):
                for batched in (False, True):
                    for mode in ("adaptive", "fixed", "seg", "interp"):
                        if method == "mali" and mode != "adaptive":
                            continue
                        if mode == "seg" and method != "aca":
                            continue
                        for up in (False, True):
                            yield dtype, tree, method, batched, mode, up


def save(path: str) -> None:
    from repro_torch.core import odeint, odeint_dense

    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal((2, 2)).astype(np.float32)
    res = {}
    for dtype, tree, method, batched, mode, up in configurations():
        kw = dict(rtol=1e-4, atol=1e-5, grad_method=method, use_pallas=up,
                  max_steps=64)
        if mode == "fixed":
            kw.update(solver="rk4", steps_per_interval=3)
        if mode == "seg":
            kw.update(checkpoint_segments=3)
        if mode == "interp":
            kw.update(interpolate_ts=True)
        if batched:
            kw.update(batch_axis=0)
        A, B = (a, b) if batched else (a[0], b[0])
        w = torch.tensor(W, requires_grad=True)
        if tree:
            leaves = [torch.tensor(x).to(dtype).requires_grad_()
                      for x in (A, B)]
            z0, f = {"a": leaves[0], "b": leaves[1]}, f_tree
        else:
            leaves = [torch.tensor(np.concatenate([A, B], -1)).to(
                dtype).requires_grad_()]
            z0, f = leaves[0], f_tensor
        key = f"{dtype}-{'tree' if tree else 'tensor'}-{method}-" \
              f"{'batched' if batched else 'solo'}-{mode}-pallas{up}"
        try:
            ys, st = odeint(f, z0, TS, (w,), **kw)
            outs = list(ys.values()) if tree else [ys]
            loss = sum((y.float() ** 2).sum() for y in outs)
            grads = torch.autograd.grad(loss, leaves + [w])
        except ValueError:
            res[key] = "error"
            continue
        res[key] = ([y.detach() for y in outs] + list(grads) + list(st))
    sol, _ = odeint_dense(f_tensor, torch.tensor(a[0]), 0.0, 1.0,
                          (torch.tensor(W),), rtol=1e-5, atol=1e-6)
    res["odeint_dense"] = [sol.evaluate(torch.linspace(0, 1, 7))]
    torch.save(res, path)
    print(f"saved {len(res)} configurations to {path}")


def compare(path_a: str, path_b: str) -> int:
    ra, rb = torch.load(path_a), torch.load(path_b)
    both = [k for k in ra if k in rb and "error" not in (ra[k], rb[k])]
    differ = [k for k in both
              if len(ra[k]) != len(rb[k])
              or not all(torch.equal(x, y) for x, y in zip(ra[k], rb[k]))]
    only = sorted(set(ra) ^ set(rb))
    refused = sorted(k for k in ra if k in rb and "error" in (ra[k], rb[k]))
    print(f"{len(both)} compared, {len(differ)} differ: {differ}")
    print(f"refused by one tree or both: {refused}")
    if only:
        print(f"in one file only: {only}")
    return 1 if differ else 0


if __name__ == "__main__":
    if sys.argv[1] == "save":
        save(sys.argv[2])
    else:
        raise SystemExit(compare(sys.argv[2], sys.argv[3]))
