"""The port's mock prover (`spectre_tpu_torch/plonk/mock.py`) against the
reference's (`spectre_tpu/plonk/mock.py`) on the same assignments.

The reference's verdict and failure message, exactly (the port raises
ValueError where the reference asserts): on the readiness circuit of
`prover_service/selfverify.py` as built and with a flipped advice cell (a
gate's), a broken copy and a lookup miss; on the TINY committee update with
a broken copy and a lookup miss (every gated advice cell there is also
copied, so a flip is caught as a copy). The TINY committee's whole verdict
is in `tests/test_torch_mock_committee.py`; the TINY step's (a 24.6 M-cell
mock) runs on the card, `tests/test_torch_cuda.py::test_step_mock_tiny` (at k=19).
"""

import copy

import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.fields import bn254 as rbn
from spectre_tpu.models import CommitteeUpdateCircuit as RefCommittee
from spectre_tpu.plonk.mock import mock_prove as ref_mock
from spectre_tpu.prover_service.selfverify import _tiny_setup as ref_tiny_setup
from spectre_tpu.witness import default_committee_update_args as ref_committee_args
from spectre_tpu_torch import convert
from spectre_tpu_torch.plonk.mock import mock_prove


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def verdicts(asg):
    """(the reference's verdict, the port's) on one reference assignment:
    True, or the failure's message."""
    try:
        want = ref_mock(asg.config, asg)
    except AssertionError as e:
        want = str(e)
    port = convert.assignment(asg)
    try:
        got = mock_prove(port.config, port, device="cpu")
    except ValueError as e:
        got = str(e)
    return want, got


def _tiny_flip_gate(a):
    a.advice[0][2] = 4                 # y: in the gate, in no copy


def _tiny_flip_copied(a):
    a.advice[0][1] = 9                 # x, the gate's first operand


def _tiny_copy(a):
    a.advice[0][4] = 6                 # the fixed constant's copy


def _tiny_lookup(a):
    a.lookup_advice[0][0] = 99         # outside the 4-bit table
    a.advice[0][0] = 99


@pytest.mark.parametrize("tamper", [None, _tiny_flip_gate, _tiny_flip_copied, _tiny_copy,
                                    _tiny_lookup],
                         ids=["as-built", "flipped-gate-cell", "flipped-operand",
                              "broken-copy", "lookup-miss"])
def test_readiness_circuit(tamper):
    _, _, asg, _ = ref_tiny_setup()
    asg = copy.deepcopy(asg)
    if tamper is not None:
        tamper(asg)
    want, got = verdicts(asg)
    assert got == want
    assert (want is True) == (tamper is None)


@pytest.fixture(scope="module")
def committee():
    """The reference's TINY committee assignment at k=13 (its mock test's
    shape)."""
    args = ref_committee_args(RSPEC.TINY)
    ctx = RefCommittee.build_context(args, RSPEC.TINY)
    cfg = ctx.auto_config(k=13, lookup_bits=RefCommittee.default_lookup_bits)
    return ctx.assignment(cfg)


def _break_copy(asg):
    """One side of a copy in the middle of the list, when it is advice."""
    cfg = asg.config
    advice = {cfg.col_gate_advice(j): j for j in range(cfg.num_advice)}
    for (ca, ra), (cb, rb) in asg.copies[len(asg.copies) // 2:]:
        if cb in advice:
            j = advice[cb]
            asg.advice[j][rb] = (int(asg.advice[j][rb]) + 1) % rbn.R
            return


def _miss_lookup(asg):
    col = asg.lookup_advice[0]
    col[len(col) // 3] = 1 << 40


@pytest.mark.parametrize("tamper", [_break_copy, _miss_lookup],
                         ids=["broken-copy", "lookup-miss"])
def test_tiny_committee_tampered(committee, tamper):
    asg = copy.copy(committee)
    asg.advice = [list(c) for c in committee.advice]
    asg.lookup_advice = [list(c) for c in committee.lookup_advice]
    tamper(asg)
    want, got = verdicts(asg)
    assert want is not True and got == want
