"""``ops/scan.max_scan`` on the CPU, where it takes its plain version.

The packed binning's five running maxima go through it (``binning._cummax``),
and every ``PackedBins`` field is held to ``dirt_tpu`` by the binning tests.
Here: the scan equals ``numpy.maximum.accumulate`` on the edge cases the
card tests run (``tests/test_torch_cuda.py``: lengths around a tile, the
1,001,112-face sphere's pool, the whole int64 range, constant and strictly
decreasing inputs) and on runs as the binning scans them, and the
wrapper refuses what the kernel does not take, on every device.
"""

import numpy as np
import pytest
import torch

from _torch_port_scene import SCAN_KINDS, SCAN_LENGTHS, scan_input
from dirt_tpu_torch.ops import binning, scan


@pytest.mark.parametrize("kind", SCAN_KINDS)
@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_max_scan_equals_numpy_running_max(n, kind):
    x = scan_input(kind, n, seed=n)
    got = scan.max_scan(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.maximum.accumulate(x))


@pytest.mark.parametrize("n, runs, fill", [(1, 1, -1), (5000, 37, -1),
                                           (100_003, 9_000, 0)])
def test_max_scan_spreads_runs_as_the_binning_scans_them(n, runs, fill):
    """``fill`` between run starts and non-decreasing values above it at
    them: each element takes its run's start value."""
    rng = np.random.RandomState(n)
    starts = np.sort(rng.choice(n, runs, replace=False))
    values = np.sort(rng.randint(fill + 1, 10 * n, runs))
    x = np.full(n, fill, np.int64)
    x[starts] = values
    run = np.cumsum(x != fill) - 1
    want = np.where(run >= 0, values[np.maximum(run, 0)], fill)
    np.testing.assert_array_equal(scan.max_scan(torch.from_numpy(x)).numpy(),
                                  want)


def test_max_scan_of_nothing_is_empty():
    assert scan.max_scan(torch.zeros(0, dtype=torch.int64)).shape == (0,)


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 3), dtype=torch.int64),
    torch.zeros(12, dtype=torch.int32),
    torch.arange(24, dtype=torch.int64)[::2],
], ids=["2-d", "int32", "non-contiguous"])
def test_max_scan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError, match="contiguous 1-D int64"):
        scan.max_scan(bad)


def test_binning_scans_through_max_scan():
    x = torch.tensor([-1, 5, -1, -1, 7, -1], dtype=torch.int64)
    with pytest.MonkeyPatch.context() as patch:
        calls = []
        patch.setattr(scan, "max_scan",
                      lambda v: calls.append(v) or scan.max_scan_plain(v))
        assert binning._cummax(x).tolist() == [-1, 5, 5, 5, 7, 7]
    assert len(calls) == 1
