"""The no-JAX check compares whole top-level names; nothing under benchmark/
imports JAX, the JAX package or the old harness."""
import ast
import os

from benchmark import guard, spec


def test_flags_jax_and_the_jax_package_not_the_port():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "jdeflate_tpu",
            "jdeflate_tpu.codec.inflate", "jdeflate_tpu_torch",
            "jdeflate_tpu_torch.codec.inflate", "jaxtyping", "numpy",
            "flax.linen"]
    assert guard.loaded(modules=dict.fromkeys(mods)) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "jdeflate_tpu", "jdeflate_tpu.codec.inflate"]


def test_flags_the_old_harness():
    mods = ["bench", "chip_smoke", "scripts.devtime",
            "jdeflate_tpu_torch.bench", "jdeflate_tpu_torch.bench.corpus",
            "jdeflate_tpu_torch.benchmarks", "benchmark.harness"]
    assert guard.offenders(dict.fromkeys(mods)) == [
        "bench", "chip_smoke", "jdeflate_tpu_torch.bench",
        "jdeflate_tpu_torch.bench.corpus", "scripts.devtime"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    seen = 0
    for root, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                seen += 1
                names = list(_imports(os.path.join(root, f)))
                assert not guard.offenders(dict.fromkeys(names)), (f, names)
    assert seen > 10


def test_reference_imports_nothing_of_the_program():
    names = set(_imports(os.path.join(spec.HERE, "reference.py")))
    assert names <= {"__future__", "zlib", "numpy"}
