"""Build the JAX package's C++ transform library once, before the test
workers start.

``ctvae_tpu.native`` builds ``libctvae_native.so`` at first use, writing
the compiler's output straight to that path. Where parallel test workers
race to build it, one can load a half-written file and fall back to PIL,
and ``tests/test_native.py`` then skips its tests. Building it here, in
the xdist controller (or in a run without xdist) and never in a worker,
leaves every worker a complete library to load.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # an xdist worker
        return
    from ctvae_tpu import native
    native.available()
