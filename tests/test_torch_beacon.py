"""The port's Beacon client (`preprocessor/beacon.py`) and the host modules
it stands on (`utils/faults.py`, `breaker.py`, `health.py`, `profiling.py`,
`observability/`), against a local fake Beacon-API server on 127.0.0.1.

As the reference's `tests/test_beacon_http.py`: the server serves JSON built
from the deterministic default args, the port's client fetches it and its
converters turn it into the args the reference's converters give. The
resilience paths (retries, Retry-After, 4xx, the breaker, fault plans, the
quorum) run with an injected sleep, rng and breaker clock: no test waits on
the wall clock.
"""

import dataclasses
import os
import sys
import tempfile
import urllib.error

import pytest
import torch

from spectre_tpu import spec as RSPEC
from spectre_tpu.preprocessor import (rotation_args_from_update as ref_rotation,
                                      step_args_from_finality_update as ref_step)
from spectre_tpu.utils import faults as rfaults
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.fields import bls12_381 as bls
from spectre_tpu_torch.observability import metrics, tracing
from spectre_tpu_torch.preprocessor import (BeaconClient, rotation_args_from_update,
                                            spec_tests as ST, ssz,
                                            step_args_from_finality_update)
from spectre_tpu_torch.preprocessor.beacon import (BeaconQuorum, CircuitBreakerOpen,
                                                   QuorumNotReached, breaker_snapshot)
from spectre_tpu_torch.utils import faults, profiling
from spectre_tpu_torch.utils.breaker import BreakerOpen, CircuitBreaker
from spectre_tpu_torch.utils.health import HEALTH, ServiceHealth
from spectre_tpu_torch.witness import default_committee_update_args, default_sync_step_args
from spectre_tpu_torch.witness.rotation import mock_root
from spectre_tpu_torch.witness.types import bytes48_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TINY, RTINY = SPEC.TINY, RSPEC.TINY
PERIOD = 7
HEAD = "0x" + (b"\xab" * 32).hex()
ROOT_PATH = "/eth/v1/beacon/blocks/head/root"
FLAKY_PATH = "/flaky"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.clear()
    yield
    faults.clear()


def _hdr_json(h):
    return {"slot": str(h.slot), "proposer_index": str(h.proposer_index),
            "parent_root": "0x" + h.parent_root.hex(), "state_root": "0x" + h.state_root.hex(),
            "body_root": "0x" + h.body_root.hex()}


def _routes():
    """Beacon-API JSON from the TINY default args: the finality update in
    the flattened shape the converter reads, the committee update with the
    container-depth branch (the converter extends it)."""
    sargs, cargs = default_sync_step_args(TINY), default_committee_update_args(TINY)
    bits = bytearray((len(sargs.participation_bits) + 7) // 8)
    for i, b in enumerate(sargs.participation_bits):
        bits[i // 8] |= b << (i % 8)
    finality_update = {
        "attested_header": _hdr_json(sargs.attested_header),
        "finalized_header": _hdr_json(sargs.finalized_header),
        "finality_branch": ["0x" + b.hex() for b in sargs.finality_branch],
        "execution_payload_root": "0x" + sargs.execution_payload_root.hex(),
        "execution_branch": ["0x" + b.hex() for b in sargs.execution_payload_branch],
        "sync_aggregate": {"sync_committee_bits": "0x" + bytes(bits).hex(),
                           "sync_committee_signature": "0x" + sargs.signature_compressed.hex()},
    }
    agg = bls.g1_compress(bls.sk_to_pk(424242))
    branch = [b"\x11" * 32] * TINY.sync_committee_depth
    state_root = mock_root(cargs.committee_pubkeys_root(), [bytes48_root(agg)] + branch,
                           TINY.sync_committee_pubkeys_root_index)
    hdr = dataclasses.replace(cargs.finalized_header, state_root=state_root)
    committee_update = {
        "finalized_header": _hdr_json(hdr),
        "next_sync_committee": {"pubkeys": ["0x" + pk.hex() for pk in cargs.pubkeys_compressed],
                                "aggregate_pubkey": "0x" + agg.hex()},
        "next_sync_committee_branch": ["0x" + b.hex() for b in branch],
    }
    return sargs, cargs, {
        "/eth/v1/beacon/light_client/finality_update": {"data": finality_update},
        f"/eth/v1/beacon/light_client/updates?start_period={PERIOD}&count=1":
            [{"data": committee_update}],
        ROOT_PATH: {"data": {"root": HEAD}},
        FLAKY_PATH: {"data": {"root": HEAD}},
    }


@pytest.fixture(scope="module")
def server():
    """The fake beacon (`chip_smoke.beacon_server`, the smoke's own).
    FLAKY_PATH answers 503 with Retry-After: 0.25 to the first `flaky[0]`
    requests, then 200."""
    sargs, cargs, routes = _routes()
    flaky = [0]

    def answer(path):
        if path == FLAKY_PATH and flaky[0] > 0:
            flaky[0] -= 1
            return 503, {"Retry-After": "0.25"}
        return None

    with chip_smoke.beacon_server(routes, answer) as url:
        yield url, sargs, cargs, flaky


def _client(url, **kw):
    kw.setdefault("timeout", 10.0)
    kw.setdefault("retries", 5)
    kw.setdefault("backoff_base", 0.001)
    kw.setdefault("backoff_max", 0.01)
    kw.setdefault("total_timeout", 60.0)
    kw.setdefault("breaker_threshold", 100)
    kw.setdefault("breaker_cooldown", 30.0)
    kw.setdefault("sleep", lambda s: None)
    return BeaconClient(url, **kw)


class TestConverters:
    def test_finality_update_becomes_the_reference_args(self, server):
        url, sargs, _, _ = server
        update = _client(url).finality_update()
        pks = [bls.g1_compress((bls.Fq(x), bls.Fq(y))) for x, y in sargs.pubkeys_uncompressed]
        got = step_args_from_finality_update(update, pks, sargs.domain, TINY, device="cpu")
        want = ref_step(update, pks, sargs.domain, RTINY)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got) == dataclasses.asdict(sargs)
        # the participation bits as a list, as the reference also takes them
        listed = dict(update, sync_aggregate=dict(update["sync_aggregate"],
                                                  sync_committee_bits=sargs.participation_bits))
        assert step_args_from_finality_update(listed, pks, sargs.domain, TINY,
                                              device="cpu").participation_bits == \
            sargs.participation_bits

    def test_committee_update_becomes_the_reference_args(self, server):
        url, _, cargs, _ = server
        update = _client(url).committee_updates(period=PERIOD)[0]
        got = rotation_args_from_update(update, TINY)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref_rotation(update, RTINY))
        assert got.pubkeys_compressed == cargs.pubkeys_compressed
        assert len(got.sync_committee_branch) == TINY.sync_committee_depth + 1

    @pytest.mark.parametrize("what", ["finality branch", "execution branch",
                                      "aggregate signature", "sync committee branch"])
    def test_refusals_carry_the_reference_messages(self, server, what):
        url, sargs, _, _ = server
        c = _client(url)
        pks = [bls.g1_compress((bls.Fq(x), bls.Fq(y))) for x, y in sargs.pubkeys_uncompressed]
        bad = "0x" + (b"\x42" * 32).hex()
        if what == "sync committee branch":
            upd = c.committee_updates(period=PERIOD)[0]
            upd = dict(upd, next_sync_committee_branch=[bad] * TINY.sync_committee_depth)
            calls = (lambda: ref_rotation(upd, RTINY), lambda: rotation_args_from_update(upd, TINY))
        else:
            upd = c.finality_update()
            if what == "finality branch":
                upd = dict(upd, finality_branch=[bad] * TINY.finalized_header_depth)
            elif what == "execution branch":
                upd = dict(upd, execution_payload_root=bad)
            else:
                sig = bls.g2_compress(bls.g2_curve.mul(bls.G2_GEN, 123))
                upd = dict(upd, sync_aggregate=dict(upd["sync_aggregate"],
                                                    sync_committee_signature=sig.hex()))
            calls = (lambda: ref_step(upd, pks, sargs.domain, RTINY),
                     lambda: step_args_from_finality_update(upd, pks, sargs.domain, TINY,
                                                            device="cpu"))
        with pytest.raises(AssertionError) as ref_err:
            calls[0]()
        with pytest.raises(ValueError) as err:
            calls[1]()
        assert str(err.value) == str(ref_err.value) and what in str(err.value)

    def test_head_root_and_bootstrap_paths(self, server):
        url, _, _, _ = server
        c = _client(url)
        assert c.head_block_root() == HEAD
        assert c.sync_period(TINY, 3 * TINY.slots_per_period + 1) == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            c.bootstrap(HEAD)      # this server has no bootstrap route
        assert e.value.code == 404


class TestWalkthrough:
    def test_readme_acquisition_path(self):
        """README's CPU walkthrough as written: a generated TINY fixture
        through chip_smoke's converter and server, the port's client and
        converters, equal to the loader's args and to the reference's
        converters on the same JSON."""
        with tempfile.TemporaryDirectory() as d:
            ST.generate_spec_test(d, TINY, 7, "sync", device="cpu")
            period, routes = chip_smoke.beacon_routes(d, TINY)
            gvr = bytes.fromhex(ST.read_meta(d)["genesis_validators_root"][2:])
            domain = ssz.compute_domain(ssz.DOMAIN_SYNC_COMMITTEE,
                                        ST.CAPELLA_FORK_VERSION["tiny"], gvr)
            with chip_smoke.beacon_server(routes) as url:
                c = BeaconClient(url)
                boot = c.bootstrap(c.head_block_root())
                fin = c.finality_update()
                upd = c.committee_updates(period)[0]
            pubkeys = boot["current_sync_committee"]["pubkeys"]
            step = step_args_from_finality_update(fin, pubkeys, domain, TINY, device="cpu")
            rot = rotation_args_from_update(upd, TINY)
            assert (step, rot) == ST.read_test_files_and_gen_witness(d, TINY, device="cpu")
        assert period == TINY.sync_period(step.attested_header.slot)
        assert rot.finalized_header == step.attested_header
        assert dataclasses.asdict(step) == dataclasses.asdict(ref_step(fin, pubkeys, domain,
                                                                       RTINY))
        assert dataclasses.asdict(rot) == dataclasses.asdict(ref_rotation(upd, RTINY))


class TestResilience:
    def test_503_then_success_honours_retry_after(self, server):
        url, _, _, flaky = server
        sleeps = []
        c = _client(url, sleep=sleeps.append, rng=lambda: 0.0)
        flaky[0] = 2
        r0 = HEALTH.get("beacon_retries")
        assert c._get(FLAKY_PATH)["data"]["root"] == HEAD
        assert sleeps == [0.25, 0.25]       # rng 0 gives no backoff: Retry-After floors it
        assert HEALTH.get("beacon_retries") == r0 + 2
        assert c.breaker_state == "closed"

    def test_backoff_is_full_jitter_over_exponential_steps(self, server):
        url, _, _, _ = server
        sleeps = []
        c = _client(url, sleep=sleeps.append, rng=lambda: 0.5, backoff_base=0.001,
                    backoff_max=0.006)
        faults.install_plan("beacon.fetch:timeout:4")
        assert c.head_block_root() == HEAD
        assert sleeps == [0.0005, 0.001, 0.002, 0.003]

    def test_4xx_raises_at_once(self, server):
        url, _, _, _ = server
        sleeps = []
        c = _client(url, sleep=sleeps.append)
        with pytest.raises(urllib.error.HTTPError) as e:
            c._get("/nonexistent")
        assert e.value.code == 404 and sleeps == []

    def test_retries_run_out(self, server):
        url, _, _, _ = server
        sleeps = []
        c = _client(url, sleep=sleeps.append, retries=2)
        faults.install_plan("beacon.fetch:connreset:5")
        with pytest.raises(ConnectionResetError):
            c.head_block_root()
        assert len(sleeps) == 2 and faults.fired_count("beacon.fetch") == 3

    def test_total_deadline(self, server):
        url, _, _, _ = server
        with pytest.raises(TimeoutError, match="total deadline"):
            _client(url, total_timeout=0.0).head_block_root()

    def test_fault_plan_from_the_environment(self, server, monkeypatch):
        url, _, _, _ = server
        sleeps = []
        monkeypatch.setenv(faults.ENV_VAR, "beacon.fetch:http503:3")
        assert _client(url, sleep=sleeps.append, rng=lambda: 0.0).head_block_root() == HEAD
        assert faults.fired_count("beacon.fetch") == 3 and faults.armed("beacon.fetch") == 0
        assert sleeps == [0.0, 0.0, 0.0]     # the injected 503 carries Retry-After: 0

    def test_breaker_trips_fails_fast_and_half_opens(self, server):
        url, _, _, _ = server
        now = [1000.0]
        c = _client(url, breaker_threshold=3, breaker_cooldown=5.0)
        c._breaker._clock = lambda: now[0]
        trips0, half0 = HEALTH.get("beacon_breaker_trips"), HEALTH.get("beacon_breaker_half_open")
        faults.install_plan("beacon.fetch:connreset:10")
        with pytest.raises(CircuitBreakerOpen, match="tripped"):
            c.head_block_root()
        assert faults.fired_count("beacon.fetch") == 3
        assert c.breaker_state == "open"
        assert HEALTH.get("beacon_breaker_trips") == trips0 + 1
        assert any(s["base_url"] == url and s["state"] == "open" and s["state_code"] == 2
                   for s in breaker_snapshot())
        with pytest.raises(CircuitBreakerOpen, match="open for another"):
            c.head_block_root()                 # fails fast: no attempt
        assert faults.fired_count("beacon.fetch") == 3
        now[0] += 5.0
        assert c.breaker_state == "half-open"
        with pytest.raises(CircuitBreakerOpen):
            c.head_block_root()                 # the trial fails: open again
        assert faults.fired_count("beacon.fetch") == 4
        assert HEALTH.get("beacon_breaker_trips") == trips0 + 2
        assert HEALTH.get("beacon_breaker_half_open") == half0 + 1
        faults.clear()
        now[0] += 5.0
        assert c.head_block_root() == HEAD      # the trial succeeds: closed
        assert c.breaker_state == "closed"


class _StubBeacon:
    def __init__(self, root, error=None):
        self.root, self.error, self.demoted = root, error, 0
        self.breaker_state = "closed"

    def finality_update(self):
        if self.error is not None:
            raise self.error
        return {"finalized_header": {"root": self.root}}

    def head_block_root(self):
        if self.error is not None:
            raise self.error
        return self.root

    def demote(self):
        self.demoted += 1


class TestQuorum:
    def test_lone_dissenter_is_outvoted_and_demoted(self):
        a, b, liar = _StubBeacon("0xaa"), _StubBeacon("0xaa"), _StubBeacon("0xff")
        d0 = HEALTH.get("beacon_quorum_dissent")
        upd = BeaconQuorum([a, b, liar], quorum=2).finality_update()
        assert upd["finalized_header"]["root"] == "0xaa"
        assert (a.demoted, b.demoted, liar.demoted) == (0, 0, 1)
        assert HEALTH.get("beacon_quorum_dissent") == d0 + 1

    def test_split_and_errors(self):
        with pytest.raises(QuorumNotReached, match="split"):
            BeaconQuorum([_StubBeacon("0xaa"), _StubBeacon("0xbb")], quorum=2).finality_update()
        e0 = HEALTH.get("beacon_quorum_errors")
        q = BeaconQuorum([_StubBeacon("0xaa"), _StubBeacon("0xaa"),
                          _StubBeacon(None, error=TimeoutError("down"))], quorum=2)
        assert q.finality_update()["finalized_header"]["root"] == "0xaa"
        assert HEALTH.get("beacon_quorum_errors") == e0 + 1
        down = _StubBeacon(None, error=TimeoutError("down"))
        with pytest.raises(QuorumNotReached, match="no beacon answered"):
            BeaconQuorum([down], quorum=1).finality_update()
        with pytest.raises(ValueError):
            BeaconQuorum([])

    def test_failover_skips_open_breakers(self):
        a, b = _StubBeacon("0x01"), _StubBeacon("0x02")
        a.breaker_state = "open"
        assert BeaconQuorum([a, b], quorum=2).head_block_root() == "0x02"
        b.breaker_state = "open"
        with pytest.raises(CircuitBreakerOpen, match="all 2 beacon breakers open"):
            BeaconQuorum([a, b]).head_block_root()

    def test_persistent_dissenter_trips_its_own_breaker(self):
        bc = BeaconClient("http://127.0.0.1:9", breaker_threshold=2, breaker_cooldown=60.0)
        bc.demote()
        bc.demote()
        assert bc.breaker_state == "open"


class TestHostModules:
    def test_fault_sites_and_grammar_equal_the_reference(self):
        assert list(faults.SITES) == list(rfaults.SITES)
        assert all(module.startswith("spectre_tpu_torch/") for module, _ in faults.SITES.values())
        assert faults.KINDS == rfaults.KINDS
        plan = "beacon.fetch:http503:3,backend.prove:oom,srs.load:corrupt:2"
        assert faults.parse_plan(plan) == rfaults.parse_plan(plan)
        for bad in ("a", "a:nope", "a:raise:0", "a:raise:1:2"):
            with pytest.raises(ValueError):
                faults.parse_plan(bad)
        assert faults.render_site_table().count("\n") == len(faults.SITES) + 1

    def test_mangle_and_crash(self):
        faults.install_plan("x:corrupt,y:crash")
        assert faults.mangle("x", b"abcd") == b"abbd" and faults.mangle("x", b"abcd") == b"abcd"
        with pytest.raises(faults.InjectedCrash):
            faults.check("y")
        assert faults.fired_count() == 2

    def test_breaker_and_health(self):
        now = [0.0]
        h = ServiceHealth()
        br = CircuitBreaker(threshold=2, cooldown=1.0, health=h, counter_prefix="t",
                            clock=lambda: now[0])
        br.record(False)
        br.admit()
        br.record(False)
        with pytest.raises(BreakerOpen):
            br.admit()
        now[0] = 1.0
        br.admit()
        br.record(True)
        assert br.snapshot() == {"state": "closed", "state_code": 0,
                                 "consecutive_failures": 0}
        assert (h.get("t_trips"), h.get("t_half_open")) == (1, 1)
        h.observe("x", 2.0)
        h.observe("x", 4.0)
        assert h.mean("x") == 3.0 and h.snapshot()["counters"] == {"t_half_open": 1,
                                                                  "t_trips": 1}

    def test_phase_feeds_totals_spans_and_histogram(self):
        profiling.reset()
        hist = metrics.PHASE_SECONDS.labels(phase="test/phase")
        n0 = hist.snapshot()["count"]
        with tracing.trace("job-1") as tr:
            with profiling.phase("test/phase"):
                with profiling.phase("test/inner"):
                    tracing.annotate(k=1)
        assert profiling.totals()["test/phase"]["count"] == 1
        assert hist.snapshot()["count"] == n0 + 1
        assert [s.name for s in tr.root.children] == ["test/phase"]
        assert tr.root.children[0].children[0].meta == {"k": 1}
        assert tracing.get_trace("job-1") is tr
        events = tracing.chrome_trace(tr)["traceEvents"]
        assert [e["name"] for e in events] == ["job", "test/phase", "test/inner"]
        assert set(tracing.phase_seconds(tr)) == {"test/phase", "test/inner"}
