"""The port, its chip smoke and the rank sides of its multi-rank tests
import neither JAX nor the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_sharded_ranks.py",
    ROOT / "tests" / "torch_sharded_lm_ranks.py",
    ROOT / "tests" / "torch_node_dryrun_ranks.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for lineno, mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)}:{lineno} imports {mod}"


def test_the_port_has_modules():
    assert len(FILES) > 10
    assert (ROOT / "chip_smoke.py").is_file()
    port = ROOT / "src" / "repro_torch"
    assert port / "serve" / "node_engine.py" in FILES
    assert port / "serve" / "__init__.py" in FILES
    assert port / "serve" / "engine.py" in FILES
    assert port / "kernels" / "flash_attention.py" in FILES
    assert port / "kernels" / "ssd_scan.py" in FILES
    assert port / "models" / "mamba2.py" in FILES
    assert port / "configs" / "mamba2_2_7b.py" in FILES
    for name in ("__init__", "synthetic", "timeseries", "threebody"):
        assert port / "data" / f"{name}.py" in FILES
    for name in ("__init__", "adamw", "schedule"):
        assert port / "optim" / f"{name}.py" in FILES
    for name in ("run", "common", "reverse_error", "method_costs",
                 "classification", "reliability", "solver_robustness",
                 "timeseries", "threebody", "memory", "dense_eval",
                 "failure_overhead", "mali_memory"):
        assert port / "benchmarks" / f"{name}.py" in FILES
    assert port / "core" / "odeint_mali.py" in FILES
    assert port / "examples" / "three_body.py" in FILES
    assert port / "examples" / "latent_timeseries.py" in FILES
    # dense and MoE LMs, LM training with NODE blocks
    for name in ("moe", "frontends", "transformer", "lm"):
        assert port / "models" / f"{name}.py" in FILES
    for name in ("qwen1_5_32b", "qwen2_72b", "command_r_plus_104b",
                 "command_r_35b", "deepseek_moe_16b", "qwen3_moe_235b_a22b",
                 "llava_next_34b", "musicgen_medium"):
        assert port / "configs" / f"{name}.py" in FILES
    for name in ("sgd", "grad_utils"):
        assert port / "optim" / f"{name}.py" in FILES
    for name in ("__init__", "state", "loop"):
        assert port / "train" / f"{name}.py" in FILES
    for name in ("__init__", "checkpoint"):
        assert port / "ckpt" / f"{name}.py" in FILES
    assert port / "launch" / "train.py" in FILES
    assert port / "examples" / "serve_lm.py" in FILES
    assert port / "examples" / "train_node_lm.py" in FILES
    assert port / "benchmarks" / "node_lm.py" in FILES
    # sharded batched solving
    for name in ("__init__", "sharding", "collectives"):
        assert port / "distributed" / f"{name}.py" in FILES
    # the sharded LM: per-rank regions beside the rules
    assert port / "distributed" / "regions.py" in FILES
    assert port / "launch" / "mesh.py" in FILES
    assert port / "benchmarks" / "sharded_solve.py" in FILES
    # the solver analysis, the checkers and the quickstart
    for name in ("__init__", "__main__", "findings", "entry_points",
                 "graph_walk", "rules", "ast_lint"):
        assert port / "analysis" / f"{name}.py" in FILES
    for name in ("solver_lint", "check_docs", "check_bench_schema"):
        assert port / "tools" / f"{name}.py" in FILES
    assert port / "examples" / "quickstart.py" in FILES
