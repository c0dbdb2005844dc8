"""The TINY committee update through `AppCircuit.mock` in both packages: the
witness built from the default args, sized at k=13 (the reference's mock
test's shape) and every gate, copy, lookup and SHA-region constraint
checked; both verdicts True. The port evaluates its ~3,200 field products
a row through the plain Montgomery product on the CPU (~75 s of one
worker); the tampered cases are in `tests/test_torch_mock.py`."""

import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.models import CommitteeUpdateCircuit as RefCommittee
from spectre_tpu.witness import default_committee_update_args as ref_args
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.models import CommitteeUpdateCircuit
from spectre_tpu_torch.witness import default_committee_update_args


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_tiny_committee_mock_verdict_equals_the_reference():
    want = RefCommittee.mock(ref_args(RSPEC.TINY), RSPEC.TINY, k=13)
    got = CommitteeUpdateCircuit.mock(default_committee_update_args(SPEC.TINY), SPEC.TINY,
                                      k=13, device="cpu")
    assert want is True and got is True
