"""The port's serving gateway and load generator (`spectre_tpu_torch/gateway/`,
`spectre_tpu_torch/loadgen/`) against the reference's.

The reference's drills (`tests/test_gateway.py`), case for case, on the
port: cache semantics (ETag = content digest, stable across restarts;
If-None-Match -> 304; `immutable` only on sealed periods; head-period short
TTL), pack byte-identity against direct UpdateStore reads, pack survival
across restart replay and a scrubber pass (the offline `scrub` CLI keeps a
follower directory whole), corrupt-pack quarantine -> rebuild, the
`gateway.pack_write` fault drill, counter parity into /metrics, and the
acceptance drill: a follower proves 4 periods, packs seal, a 10^4-client
Zipf load run completes with zero sealed-period store fallbacks while a
fault schedule is active.

Then the port against the reference on the same seeded inputs: pack bytes,
canonical bodies, ETags and cache headers are equal, and a drill with the
same seed issues the same request sequence.
"""

import json
import os

import pytest
import torch

from spectre_tpu_torch.follower.updates import UpdateStore
from spectre_tpu_torch.gateway import (Gateway, GatewayCache, PackBuilder,
                                 canonical_update_body, decode_pack,
                                 encode_pack)
from spectre_tpu_torch.gateway.packs import PACK_MAGIC, PACK_SUFFIX
from spectre_tpu_torch.loadgen import InProcessTarget, ZipfSampler, run_drill
from spectre_tpu_torch.prover_service.scrubber import Scrubber
from spectre_tpu_torch.utils import faults
from spectre_tpu_torch.utils.health import HEALTH, ServiceHealth


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _result(period: int) -> dict:
    return {"proof": "0x" + bytes([period % 251]).hex() * 48,
            "committee_poseidon": hex(period * 7919 + 13),
            "instances": [hex(period), hex(period + 1)]}


def _mk_store(directory, periods, start: int = 5,
              health=HEALTH) -> UpdateStore:
    store = UpdateStore(str(directory), health=health)
    for p in range(start, start + periods):
        store.append_committee(p, _result(p))
    return store


def _store_body(store, period: int) -> bytes:
    """The canonical encoding of a direct UpdateStore read — the bytes
    every gateway path must match exactly."""
    return canonical_update_body(store.get_committee(period))


# -- hot cache ---------------------------------------------------------------


class TestGatewayCache:
    def test_byte_budget_lru_eviction_counted(self):
        h = ServiceHealth()
        c = GatewayCache(cache_mb=10 / (1 << 20), health=h)   # 10 bytes
        assert c.put("a", "A", 4) and c.put("b", "B", 4)
        assert c.get("a") == "A"                 # refresh: a is now MRU
        assert c.put("c", "C", 4)                # evicts b (LRU)
        assert c.get("b") is None
        assert c.get("a") == "A" and c.get("c") == "C"
        assert h.get("gateway_cache_evictions") == 1
        st = c.stats()
        assert st["entries"] == 2 and st["bytes"] == 8
        assert st["hits"] == 3 and st["misses"] == 1

    def test_oversize_entry_refused_not_thrashed(self):
        h = ServiceHealth()
        c = GatewayCache(cache_mb=10 / (1 << 20), health=h)
        c.put("a", "A", 8)
        assert not c.put("big", "B", 64)         # larger than the budget
        assert c.get("a") == "A"                 # hot set untouched
        assert h.get("gateway_cache_evictions") == 0

    def test_invalidate_and_clear(self):
        c = GatewayCache(cache_mb=1)
        c.put("a", "A", 4)
        c.invalidate("a")
        assert c.get("a") is None
        c.put("b", "B", 4)
        c.clear()
        assert c.stats()["entries"] == 0 and c.stats()["bytes"] == 0


# -- pack format -------------------------------------------------------------


class TestPackFormat:
    def test_roundtrip_and_slice_offsets(self):
        entries = [(7, "e7", b'{"p":7}'), (8, "e8", b'{"period":8}')]
        data = encode_pack(7, entries, tail=False)
        assert data.startswith(PACK_MAGIC)
        index, base = decode_pack(data)
        assert index["start"] == 7 and index["count"] == 2
        assert index["tail"] is False
        for ent, (_, etag, body) in zip(index["entries"], entries):
            assert ent["etag"] == etag
            off, ln = base + ent["offset"], ent["length"]
            assert data[off:off + ln] == body

    def test_bad_magic_raises(self):
        with pytest.raises(ValueError, match="magic"):
            decode_pack(b"NOTAPACK" + b"\x00" * 16)


# -- HTTP cache semantics ----------------------------------------------------


class TestServingSemantics:
    def test_etag_is_content_digest_and_stable_across_restart(self,
                                                              tmp_path):
        store = _mk_store(tmp_path, periods=6)
        gw = Gateway(store, pack_periods=4)
        _, hdr, _ = gw.handle_http("/v1/update/6")
        assert hdr["ETag"] == f'"{store.committee_digest(6)}"'
        built = HEALTH.get("gateway_packs_built")
        # restart: fresh store + gateway over the same dir — the ETag is
        # the journaled content digest, so it cannot move; the packs
        # replay from their journal instead of rebuilding
        gw2 = Gateway(UpdateStore(str(tmp_path)), pack_periods=4)
        _, hdr2, _ = gw2.handle_http("/v1/update/6")
        assert hdr2["ETag"] == hdr["ETag"]
        assert HEALTH.get("gateway_packs_built") == built

    def test_304_on_if_none_match(self, tmp_path):
        gw = Gateway(_mk_store(tmp_path, periods=4), pack_periods=2)
        n0 = HEALTH.get("gateway_304s")
        st, hdr, body = gw.handle_http("/v1/update/6")
        assert st == 200
        st2, hdr2, body2 = gw.handle_http(
            "/v1/update/6", {"If-None-Match": hdr["ETag"]})
        assert st2 == 304 and body2 == b""
        assert hdr2["ETag"] == hdr["ETag"]       # revalidation re-pins it
        assert HEALTH.get("gateway_304s") == n0 + 1
        # a stale validator re-downloads
        st3, _, body3 = gw.handle_http(
            "/v1/update/6", {"If-None-Match": '"deadbeef"'})
        assert st3 == 200 and body3 == body

    def test_immutable_only_on_sealed_periods(self, tmp_path):
        store = _mk_store(tmp_path, periods=4)    # periods 5..8, tip 8
        gw = Gateway(store, pack_periods=2, head_ttl_s=7)
        for p in (5, 6, 7):
            _, hdr, _ = gw.handle_http(f"/v1/update/{p}")
            assert "immutable" in hdr["Cache-Control"], p
            assert "max-age=31536000" in hdr["Cache-Control"]
        # the head (tip) period may still change: short TTL, no immutable
        _, hdr, _ = gw.handle_http("/v1/update/8")
        assert hdr["Cache-Control"] == "public, max-age=7"
        # ranges: immutable only when the whole range is sealed
        _, hdr, _ = gw.handle_http("/v1/updates?start=5&count=3")
        assert "immutable" in hdr["Cache-Control"]
        _, hdr, _ = gw.handle_http("/v1/updates?start=7&count=2")
        assert "immutable" not in hdr["Cache-Control"]
        # bootstrap is tip-derived: never immutable
        _, hdr, _ = gw.handle_http("/v1/bootstrap")
        assert "immutable" not in hdr["Cache-Control"]

    def test_single_update_byte_identical_to_store_read(self, tmp_path):
        store = _mk_store(tmp_path, periods=5)
        gw = Gateway(store, pack_periods=2)
        for p in range(5, 10):
            _, _, body = gw.handle_http(f"/v1/update/{p}")
            assert body == _store_body(store, p), p

    def test_range_byte_identical_and_missing(self, tmp_path):
        store = _mk_store(tmp_path, periods=5)    # 5..9
        gw = Gateway(store, pack_periods=2)
        st, _, body = gw.handle_http("/v1/updates?start=4&count=4")
        obj = json.loads(body)
        assert obj["missing"] == [4]
        updates, missing = store.range_committee(4, 4)
        manual = json.dumps({"missing": missing, "updates": updates},
                            sort_keys=True, separators=(",", ":")).encode()
        assert body == manual
        # range etag revalidates
        _, hdr, _ = gw.handle_http("/v1/updates?start=5&count=3")
        st2, _, _ = gw.handle_http("/v1/updates?start=5&count=3",
                                   {"If-None-Match": hdr["ETag"]})
        assert st2 == 304

    def test_bootstrap_document(self, tmp_path):
        store = _mk_store(tmp_path, periods=4)
        gw = Gateway(store, pack_periods=2)
        st, hdr, body = gw.handle_http("/v1/bootstrap")
        assert st == 200
        obj = json.loads(body)
        assert obj["anchor_period"] == 5 and obj["tip_period"] == 8
        assert canonical_update_body(obj["update"]) == \
            _store_body(store, 5)
        st2, _, _ = gw.handle_http("/v1/bootstrap",
                                   {"If-None-Match": hdr["ETag"]})
        assert st2 == 304

    def test_missing_and_malformed_requests(self, tmp_path):
        gw = Gateway(_mk_store(tmp_path, periods=2), pack_periods=2)
        st, hdr, _ = gw.handle_http("/v1/update/99")
        assert st == 404 and hdr["Cache-Control"] == "no-store"
        assert gw.handle_http("/v1/nope")[0] == 404
        assert gw.handle_http("/v1/update/xyz")[0] == 400
        assert gw.handle_http("/v1/updates?count=3")[0] == 400


# -- pack lifecycle ----------------------------------------------------------


class TestPackLifecycle:
    def test_every_sealed_period_is_pack_covered(self, tmp_path):
        """Full packs over aligned ranges + ONE tail pack over the
        sealed remainder: no sealed period is ever left to the store."""
        store = _mk_store(tmp_path, periods=8)    # 5..12, tip 12
        gw = Gateway(store, pack_periods=3)
        fb0 = HEALTH.get("gateway_store_fallbacks")
        for p in range(5, 12):                    # every sealed period
            assert gw.packs.pack_for(p) is not None, p
            st, _, body = gw.handle_http(f"/v1/update/{p}")
            assert st == 200 and body == _store_body(store, p)
        assert HEALTH.get("gateway_store_fallbacks") == fb0

    def test_tail_pack_rebuilt_as_tip_advances(self, tmp_path):
        store = _mk_store(tmp_path, periods=3)    # 5..7
        gw = Gateway(store, pack_periods=4)
        tail0 = gw.packs.pack_for(5)
        assert tail0 is not None and tail0["tail"]
        live0 = gw.live_artifacts()
        store.append_committee(8, _result(8))     # append hook reseals
        tail1 = gw.packs.pack_for(7)
        assert tail1 is not None and tail1["count"] == 3
        # the superseded tail dropped out of the live set (the scrubber
        # reaps it as an orphan — intended lifecycle)
        assert (tail0["digest"], PACK_SUFFIX) not in gw.live_artifacts()
        assert live0 != gw.live_artifacts()

    def test_packs_survive_restart_and_scrubber_pass(self, tmp_path):
        """Restart replays the pack journal (no rebuild), and a scrubber
        pass with the gateway's live set keeps every current pack while
        reaping superseded ones."""
        store = _mk_store(tmp_path, periods=7)    # 5..11
        gw = Gateway(store, pack_periods=4)       # full [5,8] + tail [9,10]
        store.append_committee(12, _result(12))   # tail reseals as [9,11]
        live = store.live_artifacts() | gw.live_artifacts()
        summary = Scrubber(store.store, lambda: live,
                           min_age_s=0.0).scrub()
        assert summary["corrupt"] == 0
        assert summary["expired"] >= 1            # the old tail pack
        for digest, suffix in gw.live_artifacts():
            assert store.store.exists(digest, suffix)
        # restart: replay, not rebuild — and serving stays pack-backed
        built = HEALTH.get("gateway_packs_built")
        fb0 = HEALTH.get("gateway_store_fallbacks")
        gw2 = Gateway(UpdateStore(str(tmp_path)), pack_periods=4)
        assert HEALTH.get("gateway_packs_built") == built
        for p in range(5, 12):
            st, _, body = gw2.handle_http(f"/v1/update/{p}")
            assert st == 200 and body == _store_body(store, p)
        assert HEALTH.get("gateway_store_fallbacks") == fb0

    def test_offline_scrub_cli_keeps_updates_and_packs(self, tmp_path):
        """The `scrub` CLI replays the follower + pack journals into its
        live set: an offline pass over a follower params dir must not
        expire the update chain or its packs (it used to see only the
        job journal)."""
        from spectre_tpu_torch.prover_service.cli import main as cli_main
        store = _mk_store(tmp_path, periods=5)
        Gateway(store, pack_periods=2)
        rc = cli_main(["scrub", "--params-dir", str(tmp_path),
                       "--min-age-s", "0"])
        assert not rc
        for p in range(5, 10):                    # chain fully intact
            assert store.get_committee(p)["period"] == p
        gw2 = Gateway(UpdateStore(str(tmp_path)), pack_periods=2)
        for p in (5, 6, 7, 8):
            assert gw2.packs.pack_for(p) is not None, p

    def test_corrupt_pack_quarantined_then_rebuilt(self, tmp_path):
        store = _mk_store(tmp_path, periods=5)    # 5..9
        gw = Gateway(store, pack_periods=2)
        meta = gw.packs.pack_for(5)
        path = store.store.path_for(meta["digest"], PACK_SUFFIX)
        raw = open(path, "rb").read()
        with open(path, "wb") as f:               # rot on disk
            f.write(raw[:-3] + b"\xff\xff\xff")
        q0 = HEALTH.get("artifacts_quarantined")
        c0 = HEALTH.get("gateway_pack_corrupt")
        st, _, body = gw.handle_http("/v1/update/5")
        assert st == 200 and body == _store_body(store, 5)
        assert HEALTH.get("gateway_pack_corrupt") == c0 + 1
        assert HEALTH.get("artifacts_quarantined") == q0 + 1
        # rotten bytes moved to quarantine/ for post-mortem; the rebuild
        # re-covers the period (same content -> same digest/path, now
        # with verifying bytes)
        qdir = store.store.quarantine_dir
        assert os.path.isdir(qdir) and os.listdir(qdir)
        meta2 = gw.packs.pack_for(5)
        assert meta2 is not None
        assert store.store.exists(meta2["digest"], PACK_SUFFIX)
        assert open(path, "rb").read() == raw     # fresh, verifying

    def test_pack_write_fault_falls_back_then_recovers(self, tmp_path,
                                                       monkeypatch):
        store = _mk_store(tmp_path, periods=5)
        monkeypatch.setenv("SPECTRE_FAULT_PLAN",
                           "gateway.pack_write:ioerror:99")
        bf0 = HEALTH.get("gateway_pack_build_failures")
        fb0 = HEALTH.get("gateway_store_fallbacks")
        gw = Gateway(store, pack_periods=2)       # every build fails
        assert HEALTH.get("gateway_pack_build_failures") > bf0
        st, _, body = gw.handle_http("/v1/update/6")
        assert st == 200 and body == _store_body(store, 6)
        assert HEALTH.get("gateway_store_fallbacks") > fb0   # degraded
        monkeypatch.delenv("SPECTRE_FAULT_PLAN")
        faults.clear()                            # disk recovers
        fb1 = HEALTH.get("gateway_store_fallbacks")
        st, _, body = gw.handle_http("/v1/update/6")
        assert st == 200 and body == _store_body(store, 6)
        assert HEALTH.get("gateway_store_fallbacks") == fb1  # pack again

    def test_torn_pack_journal_tail_tolerated(self, tmp_path):
        store = _mk_store(tmp_path, periods=5)
        gw = Gateway(store, pack_periods=2)
        jpath = gw.packs._journal_path
        with open(jpath, "a") as f:
            f.write('{"start": 5, "digest": "to')          # torn append
        gw2 = Gateway(UpdateStore(str(tmp_path)), pack_periods=2)
        st, _, body = gw2.handle_http("/v1/update/5")
        assert st == 200 and body == _store_body(store, 5)

    def test_hole_below_tip_blocks_that_pack_only(self, tmp_path):
        """An invalidated mid-chain record (being re-proved) keeps ITS
        range unpacked; the other sealed ranges still seal."""
        health = ServiceHealth()
        store = _mk_store(tmp_path, periods=6, health=health)   # 5..10
        del store._committee[6]                    # simulated hole
        pb = PackBuilder(store, pack_periods=2, health=health)
        pb.ensure_packs()
        assert pb.pack_for(6) is None and pb.pack_for(5) is None
        assert pb.pack_for(7) is not None and pb.pack_for(9) is not None


# -- counters ride HEALTH into /metrics --------------------------------------


class TestMetricsExport:
    def test_gateway_counters_and_gauges_in_prom(self, tmp_path):
        from spectre_tpu_torch.observability import prom
        gw = Gateway(_mk_store(tmp_path, periods=4), pack_periods=2)
        gw.handle_http("/v1/update/5")
        _, hdr, _ = gw.handle_http("/v1/update/6")
        gw.handle_http("/v1/update/6", {"If-None-Match": hdr["ETag"]})
        body = prom.render()
        for family in ("spectre_gateway_requests_total",
                       "spectre_gateway_304s_total",
                       "spectre_gateway_pack_hits_total",
                       "spectre_gateway_packs",
                       "spectre_gateway_cache_budget_bytes",
                       "spectre_gateway_request_seconds_bucket"):
            assert family in body, family
        # exporter untouched: the counters ride HEALTH.snapshot()
        snap = HEALTH.snapshot()["counters"]
        assert snap.get("gateway_requests", 0) >= 3
        assert snap.get("gateway_304s", 0) >= 1


# -- load generator ----------------------------------------------------------


class TestLoadgen:
    def test_zipf_sampler_skews_hot(self):
        import random
        z = ZipfSampler(100, s=1.2)
        rng = random.Random(7)
        draws = [z.sample(rng) for _ in range(4000)]
        assert all(0 <= d < 100 for d in draws)
        top = sum(1 for d in draws if d < 10)
        assert top > len(draws) * 0.5           # rank 0-9 dominate

    def test_drill_report_shape_and_304_path(self, tmp_path):
        h = ServiceHealth()
        store = _mk_store(tmp_path, periods=6, health=h)
        gw = Gateway(store, pack_periods=2, health=h)
        rep = run_drill(InProcessTarget(gw),
                        periods=list(range(10, 4, -1)), tip=10,
                        clients=50, requests=1500, seed=3, health=h)
        assert rep["requests"] == 1500
        assert rep["statuses"].get("200", 0) + \
            rep["statuses"].get("304", 0) == 1500
        assert rep["latency_ms"]["p99"] >= rep["latency_ms"]["p50"]
        assert rep["if_none_match_sent"] > 0
        assert rep["statuses"].get("304", 0) > 0
        assert rep["gateway_counters"]["gateway_requests"] == 1500
        assert rep["gateway_counters"].get("gateway_store_fallbacks",
                                           0) == 0


# -- acceptance drill --------------------------------------------------------


class TestAcceptanceDrill:
    def test_follower_to_loadgen_end_to_end_with_faults(self, tmp_path,
                                                        monkeypatch):
        """Follower proves >=3 periods -> packs seal -> a 10^4-client
        Zipf drill completes with every sealed-period response served
        from the pack/304 paths (ZERO store fallbacks), byte-identical
        to direct UpdateStore reads — with `gateway.pack_write:ioerror`
        armed and a torn follower-journal tail replayed mid-drill."""
        from test_torch_follower import (DOMAIN, TINY, FakeBeacon,
                                         _FollowerState, _drive, _mk_queue,
                                         _step_pubkeys_hex, _stop_queue)
        from spectre_tpu_torch.follower import Follower

        state = _FollowerState(TINY)
        jobs = _mk_queue(state, tmp_path)
        beacon = FakeBeacon(TINY, fin_slot=80)
        fol = Follower(TINY, beacon, jobs, directory=str(tmp_path),
                       pubkeys=_step_pubkeys_hex(TINY), domain=DOMAIN)
        # fault 1: the FIRST pack write fails with an ioerror — builds
        # must retry on later seal events, not break the follower
        monkeypatch.setenv("SPECTRE_FAULT_PLAN",
                           "gateway.pack_write:ioerror:1")
        gw = Gateway(fol.store, pack_periods=2, cache_mb=16)
        try:
            for fin_slot in (80, 144, 208, 272):   # periods 1..4
                beacon.advance(fin_slot)
                period = TINY.sync_period(fin_slot)
                _drive(fol, lambda: fol.store.has_committee(period))
        finally:
            _stop_queue(jobs)
        assert fol.store.tip_period() == 4        # sealed: 1, 2, 3
        monkeypatch.delenv("SPECTRE_FAULT_PLAN")
        faults.clear()

        # fault 2: torn follower-journal tail (crash mid-append), then
        # restart the read path over the same dir
        with open(fol.store.path, "a") as f:
            f.write('{"kind": "committee", "per')
        store2 = UpdateStore(str(tmp_path))
        assert store2.tip_period() == 4
        gw2 = Gateway(store2, pack_periods=2, cache_mb=16)
        # despite the failed first build, every sealed period is covered
        for p in (1, 2, 3):
            assert gw2.packs.pack_for(p) is not None, p

        fb0 = HEALTH.get("gateway_store_fallbacks")
        rep = run_drill(InProcessTarget(gw2), periods=[4, 3, 2, 1],
                        tip=4, clients=10_000, requests=20_000, seed=14,
                        health=HEALTH)
        # zero store fallbacks for sealed traffic -> every sealed 200
        # came off a pack slice; with the 304s that is 100% >= 95%
        assert HEALTH.get("gateway_store_fallbacks") == fb0
        assert rep["sealed_requests"] > 0
        served_cached = rep["sealed_requests"]    # all pack or 304
        assert served_cached / rep["sealed_requests"] >= 0.95
        assert rep["statuses"].get("304", 0) > 0
        bad = {k: v for k, v in rep["statuses"].items()
               if k not in ("200", "304")}
        assert not bad, bad
        # byte identity against direct store reads, post-drill
        for p in (1, 2, 3, 4):
            _, _, body = gw2.handle_http(f"/v1/update/{p}")
            assert body == _store_body(store2, p), p


# -- the port against the reference --------------------------------------------

from spectre_tpu.follower.updates import UpdateStore as RefUpdateStore   # noqa: E402
from spectre_tpu.gateway import Gateway as RefGateway                    # noqa: E402
from spectre_tpu.gateway import canonical_update_body as ref_body       # noqa: E402
from spectre_tpu.gateway import encode_pack as ref_encode_pack          # noqa: E402
from spectre_tpu.loadgen import InProcessTarget as RefInProcessTarget    # noqa: E402
from spectre_tpu.loadgen import run_drill as ref_run_drill               # noqa: E402
from spectre_tpu.utils.health import ServiceHealth as RefServiceHealth   # noqa: E402

PAIRS = {"port": (UpdateStore, Gateway, ServiceHealth),
         "reference": (RefUpdateStore, RefGateway, RefServiceHealth)}
PATHS = ([f"/v1/update/{p}" for p in range(4, 13)]
         + [f"/v1/updates?start={s}&count={c}" for s, c in
            ((5, 1), (5, 4), (6, 3), (9, 3), (11, 8), (3, 2), (13, 1))]
         + ["/v1/bootstrap", "/v1/update/x", "/v1/nothing"])
CACHE_HEADERS = ("ETag", "Cache-Control", "Content-Type")


def _gateways(tmp_path, periods=7, pack_periods=2):
    out = {}
    for name, (store_cls, gw_cls, health_cls) in PAIRS.items():
        h = health_cls()
        store = store_cls(str(tmp_path / name), health=h)
        for p in range(5, 5 + periods):
            store.append_committee(p, _result(p))
        out[name] = (store, gw_cls(store, pack_periods=pack_periods, health=h), h)
    return out


class _Recording:
    """A drill target that records every (path, If-None-Match) it is
    asked for."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []

    def get(self, path, if_none_match=None):
        self.seen.append((path, if_none_match))
        return self.inner.get(path, if_none_match=if_none_match)


class TestAgainstReference:
    def test_bodies_etags_cache_headers_and_packs_equal(self, tmp_path):
        """The same stored chain served by both gateways: every route's
        status, ETag, cache headers and body bytes are equal (304s too),
        the canonical body of each record is the same bytes, and the
        sealed packs are the same artifacts, byte for byte."""
        gws = _gateways(tmp_path)
        (ps, pg, _), (rs, rg, _) = gws["port"], gws["reference"]
        for p in range(5, 12):
            assert canonical_update_body(ps.get_committee(p)) == \
                ref_body(rs.get_committee(p))
        for path in PATHS:
            a, b = pg.handle_http(path), rg.handle_http(path)
            assert a[0] == b[0], path
            assert {k: a[1].get(k) for k in CACHE_HEADERS} == \
                {k: b[1].get(k) for k in CACHE_HEADERS}, path
            assert a[2] == b[2], path
            if a[0] == 200 and a[1].get("ETag"):
                inm = {"If-None-Match": a[1]["ETag"]}
                a2, b2 = pg.handle_http(path, inm), rg.handle_http(path, inm)
                assert a2[0] == b2[0] == 304 and a2[2] == b2[2] == b""
        assert pg.live_artifacts() == rg.live_artifacts()
        assert pg.live_artifacts()
        for digest, suffix in pg.live_artifacts():
            assert ps.store.read(digest, suffix) == rs.store.read(digest, suffix)
        entries = [(p, pg.handle_http(f"/v1/update/{p}")[1]["ETag"],
                    canonical_update_body(ps.get_committee(p))) for p in (5, 6)]
        for tail in (False, True):
            assert encode_pack(5, entries, tail) == ref_encode_pack(5, entries, tail)

    @pytest.mark.parametrize("threads", [1, 3])
    def test_drill_with_the_same_seed_issues_the_same_requests(self, tmp_path, threads):
        """A drill with the same seed, one worker or three (each seeded
        seed + i), asks both packages' gateways for the same paths with the
        same If-None-Match, and gets the same statuses."""
        gws = _gateways(tmp_path, periods=6)
        reports, seen = {}, {}
        for name, drill, target_cls in (("port", run_drill, InProcessTarget),
                                         ("reference", ref_run_drill, RefInProcessTarget)):
            store, gw, h = gws[name]
            rec = _Recording(target_cls(gw))
            reports[name] = drill(rec, periods=list(range(10, 4, -1)), tip=10, clients=40,
                                  requests=1200, seed=21, threads=threads, health=h)
            seen[name] = rec.seen
        if threads == 1:
            assert seen["port"] == seen["reference"]
        else:
            assert sorted(seen["port"], key=repr) == sorted(seen["reference"], key=repr)
        for key in ("requests", "statuses", "if_none_match_sent", "sealed_requests",
                    "sealed_304s", "ratio_304", "gateway_counters"):
            assert reports["port"][key] == reports["reference"][key], key
        assert reports["port"]["statuses"].get("304", 0) > 0


class TestServingHeads:
    def test_both_clients_read_both_gateway_heads(self, tmp_path):
        """Either package's client reads either package's follower head:
        the stored update over JSON-RPC and over the cacheable GET, a 304 on
        its second read, the range, the bootstrap and the follower's status,
        and -32007 for a period not proved."""
        from spectre_tpu.follower import Follower as RefFollower
        from spectre_tpu.prover_service import rpc as rrpc
        from spectre_tpu.prover_service import rpc_client as rclient
        from spectre_tpu_torch.follower import Follower
        from spectre_tpu_torch.prover_service import rpc as prpc
        from spectre_tpu_torch.prover_service import rpc_client as pclient
        from spectre_tpu_torch.spec import TINY

        class Beacon:
            def finality_update(self):
                raise OSError("no beacon in this test")

        class State:
            concurrency = 1

        class Jobs:
            def add_live_provider(self, provider):
                pass

            def stats(self):
                return {}

        heads = {}
        for name, fol_cls, rpc_mod in (("port", Follower, prpc), ("reference", RefFollower, rrpc)):
            store_cls = PAIRS[name][0]
            store = store_cls(str(tmp_path / name))
            for p in range(5, 9):
                store.append_committee(p, _result(p))
            st = State()
            st.jobs = Jobs()
            fol = fol_cls(TINY, Beacon(), st.jobs, store=store)
            heads[name] = rpc_mod.serve(st, port=0, background=True, follower=fol, gateway=True)
        try:
            bodies = {}
            for head, srv in heads.items():
                url = f"http://127.0.0.1:{srv.server_address[1]}"
                for client_mod in (pclient, rclient):
                    c = client_mod.ProverClient(url, timeout=30)
                    rec = c.get_light_client_update(period=6)
                    assert rec["result"] == _result(6)
                    first = c.get_update_cached(6)
                    assert c.get_update_cached(6) == first and c.cache_304s == 1
                    rng = c.get_update_range_cached(7, 4)
                    assert [u["period"] for u in rng["updates"]] == [7, 8]
                    assert rng["missing"] == [9, 10]
                    assert c.get_bootstrap_cached()
                    assert c.follower_status()["tip_period"] == 8
                    with pytest.raises(client_mod.RpcError) as exc:
                        c.get_update_cached(42)
                    assert exc.value.code == -32007
                    bodies.setdefault(client_mod.__name__, []).append((first, rng))
            for got in bodies.values():
                assert got[0] == got[1]          # the port's head == the reference's
        finally:
            for srv in heads.values():
                srv.shutdown()


def test_offline_scrub_of_a_follower_directory_expires_nothing(tmp_path, capsys):
    """An offline `scrub` of a directory holding a job journal, the
    follower's update store and the gateway's packs keeps every artifact:
    the live set is the union of the three journals."""
    from spectre_tpu_torch.prover_service.cli import main as cli_main
    from spectre_tpu_torch.prover_service.jobs import JobQueue

    q = JobQueue(lambda method, params, heartbeat=None: {"proof": "0x01", "instances": []},
                 concurrency=1, journal_dir=str(tmp_path), scrub_interval=0)
    try:
        q.wait(q.submit("genEvmProof_CommitteeUpdateCompressed", {"w": 1}), timeout=30)
    finally:
        q.stop()
    store = _mk_store(tmp_path, periods=5)
    gw = Gateway(store, pack_periods=2)
    files = sorted(os.listdir(store.store.dir))
    cli_main(["scrub", "--params-dir", str(tmp_path), "--min-age-s", "0"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["expired"] == 0 and summary["corrupt"] == 0
    assert summary["live"] == len(store.live_artifacts() | gw.live_artifacts()) + 2
    assert sorted(os.listdir(store.store.dir)) == files


def test_loadgen_cli_drills_a_store_in_process(tmp_path, capsys):
    """`python -m spectre_tpu_torch.loadgen --store-dir` builds a Gateway over
    a follower's store and drills it in process: every request answered
    200 or 304, the report's shape the reference's."""
    from spectre_tpu_torch.loadgen.__main__ import main as loadgen_main

    _mk_store(tmp_path, periods=4)
    loadgen_main(["--store-dir", str(tmp_path), "--clients", "40", "--requests", "400",
                  "--seed", "5"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["requests"] == 400
    assert set(rep["statuses"]) <= {"200", "304"} and rep["statuses"].get("304", 0) > 0
    assert rep["gateway_counters"]["gateway_requests"] == 400
