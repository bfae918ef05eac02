import pathlib
import sys

# tests import the heapq oracle as a plain module; make the tests dir
# importable regardless of how pytest was invoked
sys.path.insert(0, str(pathlib.Path(__file__).parent))

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see ONE real CPU device; only launch/dryrun.py
# requests 512 placeholder devices (and only for itself).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (run explicitly)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
        "kernels); skips without one")
