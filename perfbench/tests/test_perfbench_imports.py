"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), and the
reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

import perfbench_smoke as S

BENCH = S.ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
    if "tests" not in p.parts))
def test_no_forbidden_import_in_the_sources(path):
    tops = {m.split(".")[0] for m in _imports(BENCH / path)}
    assert not tops & FORBIDDEN
    if path.startswith("reference/"):
        assert "repro_torch" not in tops and "perfbench" not in tops


def test_a_run_loads_no_forbidden_module():
    """Import what a run imports, build a smoke model and its engine in a
    fresh process, and list the loaded top-level names."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import perfbench.run as R\n"
        "import perfbench.harness.cell, perfbench.control\n"
        "from perfbench.harness import model as M\n"
        "sys.path.insert(0, %r)\n"
        "import perfbench_smoke as S\n"
        "c = S.smoke_config('granite-moe-1b-a400m')\n"
        "w = M.make_weights(c, 0, 'cpu')\n"
        "M.port_model(c, w, 'cpu')\n"
        "import repro_torch.serving\n"
        "print(R.forbidden_modules())\n"
    ) % (str(S.ROOT / "src"), str(S.ROOT), str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_names():
    import perfbench.run as R
    assert R.forbidden_modules(["repro_torch", "repro_torch.serving",
                                "reprox", "jaxtyping", "numpy"]) == []
    assert R.forbidden_modules(["repro.kernels", "jax._src", "jaxlib",
                                "flax"]) == ["flax", "jax", "jaxlib",
                                             "repro"]
