"""No module under bench/ imports JAX, the JAX package or its benchmark
scripts: each import's top-level name is compared whole, so the port,
``repro_torch``, passes."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = set(top_names(f)) & FORBIDDEN
        if bad:
            found[str(f.relative_to(BENCH))] = sorted(bad)
    assert not found, found


def test_the_check_compares_whole_names():
    src = "import repro_torch.models\nfrom repro_torch import x\n"
    p = BENCH / "tests" / "_probe_imports.txt"
    try:
        p.write_text(src)
        assert set(top_names(p)) == {"repro_torch"}
        assert not set(top_names(p)) & FORBIDDEN
        p.write_text("import repro.models\n")
        assert set(top_names(p)) & FORBIDDEN == {"repro"}
    finally:
        p.unlink(missing_ok=True)


def test_the_reference_imports_nothing_of_the_port():
    for f in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in set(top_names(f)), f
