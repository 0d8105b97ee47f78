"""Build the native geometry library once, before any xdist worker starts:
workers that each build it through one shared temporary file race, and a loser skips the native tests."""
import importlib.util
import os


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "building_detection_tpu", "post", "_native.py")
    try:
        # loaded by path, so no `jax` import runs ahead of tests/conftest.py's platform setup
        spec = importlib.util.spec_from_file_location("_bdt_native_prebuild", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    except Exception:  # no g++: the tests take their numpy fallback, as before
        pass
