"""Nothing under flowbench/ imports JAX or the JAX package (whole top-level
names: the port's name begins with the JAX package's), the reference imports
nothing of the port, and nothing reads the repo's older benchmarks."""

import ast
from pathlib import Path

from flowbench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert imported(path) <= {"__future__", "torch", "numpy", "math", "flowbench"}, path


def test_nothing_reads_the_older_benchmarks_or_configs():
    for path in set(HERE.rglob("*.py")) - {Path(__file__).resolve()}:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                v = node.value
                assert not v.startswith(("configs/", "scripts/", "benchmarks/", "bench.py")), path


def test_the_run_names_loaded_modules_by_whole_top_level_name():
    loaded = {"unflow_tpu_torch.train": 1, "unflow_tpu_torchx": 1, "jaxlib.xla": 1,
              "unflow_tpu": 1, "flax.linen": 1, "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(loaded) == ["flax.linen", "jaxlib.xla", "unflow_tpu"]
