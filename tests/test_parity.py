"""Parity harness tests: same-platform determinism + compare logic."""

import numpy as np
import pytest

from sp_coupler.verify import parity


class TestParity:
    @pytest.mark.slow   # heavy golden-replay leg; divergence-detection
    # stays in the fast tier (test_compare_detects_divergence)
    def test_same_platform_bit_identical(self, tmp_path):
        """Two identical runs on one backend must agree bit-for-bit."""
        a = parity.run(str(tmp_path / "a.npz"), n_steps=2, les_n=8,
                       les_nz=12, n_les=2)
        b = parity.run(str(tmp_path / "b.npz"), n_steps=2, les_n=8,
                       les_nz=12, n_les=2)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert parity.compare(str(tmp_path / "a.npz"),
                              str(tmp_path / "b.npz"), verbose=False)

    def test_compare_detects_divergence(self, tmp_path):
        a = parity.run(str(tmp_path / "a.npz"), n_steps=1, les_n=8,
                       les_nz=12, n_les=2)
        data = dict(np.load(str(tmp_path / "a.npz")))
        data["step0_prof_THL"] = data["step0_prof_THL"] + 30.0
        np.savez_compressed(str(tmp_path / "c.npz"), **data)
        assert not parity.compare(str(tmp_path / "a.npz"),
                                  str(tmp_path / "c.npz"), verbose=False)
