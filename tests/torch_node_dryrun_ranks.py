"""The rank side of ``tests/test_torch_node_dryrun.py``.

    PYTHONPATH=src python tests/torch_node_dryrun_ranks.py OUT_DIR

Spawns 8 gloo ranks on the CPU once (``torch.multiprocessing.spawn``,
one thread each). Every rank runs the two NODE dry-run cells of the
reference's golden test (``launch/node_dryrun.py::run_node_cell``: train
with the adjoint and serve with ACA, batch 16, dim 8) on the 8-rank
``("data",)`` mesh; rank r writes its reports to ``OUT_DIR/rank{r}.json``.
Imports neither JAX nor the reference.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
CELLS = (("train", "adjoint"), ("serve", "aca"))
BATCH, DIM = 16, 8


def worker(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.node_dryrun import run_node_cell

        reports = [run_node_cell(kind, batch=BATCH, dim=DIM,
                                 grad_method=method, device="cpu",
                                 save=False)
                   for kind, method in CELLS]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(reports, fh)
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(out_dir: str) -> None:
    from repro_torch.launch.mesh import free_port

    mp.spawn(worker, args=(WORLD, free_port(), out_dir), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])
