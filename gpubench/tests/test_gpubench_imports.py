"""What the harness loads: a run holds no module named jax, jaxlib, flax
or vbhem_tpu (whole top-level names; the program's own name begins with
the last), and the reference imports nothing of the program."""
import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "vbhem_tpu")


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    )], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    # a whole run of a tiny cell on the CPU, through run.py's own measure
    top = _modules_after(
        "import sys; sys.path.insert(0, 'gpubench/tests')\n"
        "from conftest import run_tiny, CELLS\n"
        "for c in CELLS:\n"
        "    assert run_tiny(c)['correct']\n")
    assert "vbhem_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_run_forbids_by_whole_top_level_name(monkeypatch):
    import types
    from gpubench import run
    assert run.FORBIDDEN == FORBIDDEN
    for name in ("vbhem_tpu_torch_like", "jaxlib.xla_like", "jax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["jaxlib"]


def test_reference_imports_nothing_of_the_program():
    top = _modules_after("import gpubench.reference.vbem, "
                         "gpubench.reference.vbhem, "
                         "gpubench.reference.starts")
    assert "vbhem_tpu_torch" not in top
    assert not top & set(FORBIDDEN)
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in (
                    "__future__", "math", "typing", "numpy", "torch"), \
                    (path.name, name)
