"""No run loads JAX or the JAX package, and the reference imports nothing
of the program it judges."""
import ast
import subprocess
import sys

from portbench import isolation
from portbench.spec import PKG, ROOT


def test_top_level_names_compare_whole():
    names = ["ste_gan_torch", "ste_gan_torch.ops", "jaxtyping", "flaxen"]
    assert isolation.forbidden_loaded(names) == []
    assert isolation.forbidden_loaded(names + ["ste_gan_tpu.models"]) == [
        "ste_gan_tpu"]
    assert isolation.forbidden_loaded(["jax.numpy", "jaxlib", "optax"]) == [
        "jax", "jaxlib", "optax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        tops = isolation.top_level(_imports(path))
        assert "ste_gan_torch" not in tops, path
        assert not tops & isolation.FORBIDDEN, path


def test_harness_sources_import_no_jax():
    for path in PKG.rglob("*.py"):
        assert not isolation.top_level(_imports(path)) & isolation.FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("import sys; from portbench.tests.tiny import execute; "
            "c, r, _ = execute('gan_su.generate', 11); "
            "from portbench.isolation import forbidden_loaded; "
            "print(c, r['correct'], forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "0 True []", out.stderr


def test_reference_loads_without_the_program():
    code = ("import sys, portbench.reference.train, portbench.weights; "
            "print(sorted(n for n in sys.modules "
            "if n.split('.')[0] == 'ste_gan_torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
