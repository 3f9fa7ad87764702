"""Whole-model parity at compound coefs 5-8 (tests/test_torch_coefs.py says
how; a file of its own so that the test workers share the time)."""

import pytest

from test_torch_coefs import assert_coef_matches_flax


@pytest.mark.parametrize("coef", [5, 6, 7, 8])
def test_coef_outputs_match_flax(coef):
    assert_coef_matches_flax(coef)
