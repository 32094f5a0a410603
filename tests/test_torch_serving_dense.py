"""Port parity, end to end, for the dense and quant payload kinds: served
tokens and measured bytes of the port's `run_streaming` on the CPU equal
the JAX reference's (`test_torch_serving_parity`)."""
import pytest

from test_torch_serving_parity import assert_serving_matches_reference, weights


@pytest.fixture(scope="module")
def params():
    return weights()


@pytest.mark.parametrize("comp", ["identity", "quant"])
def test_served_tokens_and_bytes_match_reference(params, comp):
    assert_serving_matches_reference(*params, comp)
