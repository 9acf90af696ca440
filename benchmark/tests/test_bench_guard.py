"""The import guard compares whole top-level names, and nothing the
reference or the harness imports is JAX, the JAX package or the port."""

import ast
import subprocess
import sys

from benchmark.core.guard import FORBIDDEN, forbidden_modules
from benchmark.core.spec import BENCH, ROOT


def test_top_level_names_compared_whole():
    names = ["eva_vos_tpu_torch", "eva_vos_tpu_torch.engine", "jaxtyping",
             "flaxen", "torch", "eva_vos_tpu.ops", "jax", "jaxlib.xla_client",
             "flax.linen", "eva_vos_tpu"]
    assert forbidden_modules(names) == ["eva_vos_tpu", "eva_vos_tpu.ops", "flax.linen",
                                        "jax", "jaxlib.xla_client"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_sources_import_nothing_of_the_program():
    """A reference imports plain libraries and other references only."""
    banned = set(FORBIDDEN) | {"eva_vos_tpu_torch", "benchmark"}
    for path in (BENCH / "reference").glob("*.py"):
        names = {n for n in _imports(path) if not n.startswith("benchmark.reference")}
        tops = {name.partition(".")[0] for name in names}
        assert not tops & banned, (path.name, tops & banned)


def test_reference_loads_no_forbidden_module():
    code = ("import sys; from benchmark.core.spec import load_module, BENCH\n"
            "for p in sorted((BENCH / 'reference').glob('*.py')):\n"
            "    load_module(p, 'ref_' + p.stem)\n"
            "print(' '.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    tops = {n.partition(".")[0] for n in out}
    assert not tops & (set(FORBIDDEN) | {"eva_vos_tpu_torch"})


def test_harness_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))
