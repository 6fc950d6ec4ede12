import os
import sys

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see the host's real (single) device; only the dry-run
# process uses 512 placeholder devices.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); the test "
        "skips itself when none is present")
