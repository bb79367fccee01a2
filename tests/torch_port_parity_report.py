"""Parity report of the PyTorch port: runs tests/test_torch_port_*.py in
this process and prints, for each test, the largest absolute difference
among the arrays it compares with ``np.testing.assert_allclose`` /
``assert_array_equal`` (port vs JAX, or port vs port's plain version).

    JAX_PLATFORMS=cpu python tests/torch_port_parity_report.py
"""

import glob
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
_errors: dict[str, float] = {}
_current = [""]


def _recording(orig):
    def wrapped(actual, desired, *args, **kwargs):
        a = np.asarray(actual, np.float64)
        d = np.asarray(desired, np.float64)
        err = float(np.max(np.abs(a - d))) if a.size and a.shape == d.shape \
            else 0.0
        _errors[_current[0]] = max(_errors.get(_current[0], 0.0), err)
        return orig(actual, desired, *args, **kwargs)
    return wrapped


class _Recorder:
    def pytest_runtest_setup(self, item):
        _current[0] = item.nodeid
        _errors.setdefault(item.nodeid, 0.0)


def main() -> int:
    sys.path.insert(0, os.path.dirname(HERE))  # pytest.ini's env plugin
    np.testing.assert_allclose = _recording(np.testing.assert_allclose)
    np.testing.assert_array_equal = _recording(np.testing.assert_array_equal)
    files = sorted(glob.glob(os.path.join(HERE, "test_torch_port_*.py")))
    rc = pytest.main(["-q", "-p", "no:cacheprovider", *files],
                     plugins=[_Recorder()])
    print("\n| test | max abs error |\n|---|---|")
    for node, err in _errors.items():
        print(f"| `{node.split('::', 1)[1]}` | {err:.3g} |")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
