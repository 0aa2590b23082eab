"""Nothing the benchmark runs loads JAX or the JAX package; the reference loads no port."""

import subprocess
import sys
import textwrap

from bench import harness

PRELUDE = textwrap.dedent(f"""
    import sys
    sys.path[:0] = [{str(harness.ROOT / 'src')!r}, {str(harness.ROOT)!r}]
""")


def run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", PRELUDE + textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = run("""
        from bench import harness
        import repro_torch, repro_torch.kernels.ops
        cell = harness.load_cell("type1.batch50k")
        for kind, names in (("traffic", ["closed_batch", "closed_shared"]),
                            ("generators", ["paper_type1", "paper_type2"]),
                            ("roofline", ["simplex", "revised"])):
            for name in names:
                harness.load_module(kind, name)
        for m in cell.per_layer:
            harness.load_module("metrics", m["name"])
        import bench.judge, bench.trace, bench.readings
        print(",".join(harness.forbidden_modules()))
    """)
    assert loaded == ""


def test_the_reference_loads_nothing_of_the_program():
    loaded = run("""
        import bench.reference.simplex64, bench.judge
        print(",".join(sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")))
    """)
    assert loaded == ""


def test_the_guard_compares_whole_top_level_names():
    allowed = ["repro_torch", "repro_torch.core.lp", "jaxtyping", "reproduce", "bench.judge"]
    assert harness.forbidden_modules(allowed) == []
    assert harness.forbidden_modules(allowed + ["repro.core.lp", "jax.numpy", "flax", "jaxlib"]) \
        == ["flax", "jax", "jaxlib", "repro"]
