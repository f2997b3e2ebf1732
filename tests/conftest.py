"""Make `pytest tests/` work with or without PYTHONPATH=src, and fall back
to the deterministic `hypothesis` stub when the real library is absent."""
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

if importlib.util.find_spec("hypothesis") is None:
    _stub_path = os.path.join(os.path.dirname(__file__), "_hypothesis_stub.py")
    _spec = importlib.util.spec_from_file_location("hypothesis", _stub_path)
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skipped when "
        "torch.cuda.is_available() is False")
