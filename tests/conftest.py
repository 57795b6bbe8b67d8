import importlib.util
import os
import sys

# Tests see ONE device (the dry-run is the only place that forces 512).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Property tests use hypothesis when available; otherwise fall back to the
# minimal deterministic shim in tests/_fallback so the suite still collects
# and runs (the real package always wins when installed).
if importlib.util.find_spec("hypothesis") is None:
    sys.path.append(os.path.join(os.path.dirname(__file__), "_fallback"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
