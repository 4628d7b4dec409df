"""On-card numerics: the GPU against the host CPU at the reference widths.

Marked ``gpu``; each test skips (from its fixture) when JAX has no GPU.
Run on a machine with a card, from the repository root:

    JAX_PLATFORMS=cuda,cpu python -m pytest -o addopts="" -m gpu tests/test_gpu.py

chip_smoke.py phase d runs the same checks (sp_coupler/verify/oncard.py).
"""

import jax
import pytest

from sp_coupler.verify import oncard

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def devices():
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
    return gpu, jax.devices("cpu")[0]


def test_les_substep_matches_cpu(devices):
    errs = oncard.les_substep(*devices, oncard.rico_grid())
    assert max(errs.values()) <= oncard.SUBSTEP_TOL, errs


def test_projection_residual_on_card(devices):
    assert oncard.projection_residual(devices[0], oncard.rico_grid()) \
        <= oncard.DIV_TOL


def test_gcm_step_matches_cpu(devices):
    errs = oncard.gcm_step(*devices)
    assert max(errs.values()) <= oncard.GCM_STEP_TOL, errs
