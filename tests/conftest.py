import jax

# f64 for the LP solver oracles; model code is dtype-explicit throughout.
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; the test decides inside itself and skips without one",
    )
