"""The port's service observability and CLI against the reference's:
`observability/prom.py` (the /metrics text), `manifest.py` (the provenance
manifest), `compilelog.py` (kernel builds and launches in the place of the
reference's XLA compile telemetry), the manifest report CLI, and the
prover CLI's `utils committee-poseidon`, `faults` and `scrub` subcommands.
"""

import json
import os
import sys

import pytest
import torch

from spectre_tpu.observability import manifest as rmanifest, metrics as rmetrics
from spectre_tpu.observability import prom as rprom
from spectre_tpu.prover_service import cli as rcli
from spectre_tpu.utils.health import ServiceHealth as RefServiceHealth
from spectre_tpu_torch import spec as SPEC
from spectre_tpu_torch.observability import compilelog, manifest, metrics, prom, tracing
from spectre_tpu_torch.observability import __main__ as report_cli
from spectre_tpu_torch.ops import kernel_lib as KL
from spectre_tpu_torch.prover_service import cli, jobs
from spectre_tpu_torch.utils.health import ServiceHealth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

SYNC = os.path.join(REPO, "consensus-spec-tests", "tests", "minimal", "capella",
                    "light_client", "sync", "pyspec_tests", "light_client_sync_selfgen")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _Jobs:
    def stats(self):
        return {"jobs": {"done": 3, "failed": 1}, "workers": 1, "queue_depth": 64}

    def retry_after_s(self):
        return 30.0


def _fill(health, registry_mod):
    for name, n in (("jobs_done", 3), ("jobs_failed", 1), ("proofs_verified", 3)):
        health.incr(name, n)
    health.observe("prove_latency_s", 1.5)
    health.observe("prove_latency_s", 2.5)
    reg = registry_mod.MetricsRegistry()
    h = reg.histogram("spectre_prove_latency_seconds", "End-to-end prove latency per "
                      "completed job (seconds)", registry_mod.LATENCY_BUCKETS)
    for v in (0.2, 1.5, 700.0):
        h.observe(v)
    vec = reg.histogram_vec("spectre_phase_seconds", "Wall-clock seconds per instrumented "
                            "prover phase", registry_mod.PHASE_BUCKETS, ("phase",))
    vec.labels(phase="job/preprocess").observe(0.3)
    return reg


# families one package renders and the other has no counterpart for (or
# that read the process: uptime, RSS, live beacon clients)
_APART = ("spectre_uptime_seconds", "spectre_process_rss_mb", "spectre_beacon_breaker_",
          "spectre_table_lru_", "spectre_msm_", "spectre_kernel_", "spectre_replica_",
          "spectre_dispatcher_", "spectre_follower_", "spectre_gateway_",
          "spectre_compile_seconds")


def _shared(text):
    return [line for line in text.splitlines()
            if not any(f" {p}" in line or line.startswith(p) for p in _APART)]


def test_metrics_text_equals_the_reference():
    ref_h, port_h = RefServiceHealth(), ServiceHealth()
    ref = rprom.render(health=ref_h, jobs=_Jobs(), registry=_fill(ref_h, rmetrics))
    got = prom.render(health=port_h, jobs=_Jobs(), registry=_fill(port_h, metrics))
    assert _shared(got) == _shared(ref)
    assert "spectre_jobs_done_total 3" in got
    assert 'spectre_prove_latency_seconds_bucket{le="+Inf"} 3' in got


def test_metrics_text_carries_the_kernels_launch_counters():
    KL.KERNELS["K3_mont_mul"].launches += 2
    text = prom.render()
    assert "# TYPE spectre_kernel_launches_total counter" in text
    assert f'spectre_kernel_launches_total{{kernel="K3_mont_mul"}} ' \
           f'{KL.KERNELS["K3_mont_mul"].launches}' in text
    for name in ("spectre_prove_latency_seconds", "spectre_queue_wait_seconds",
                 "spectre_kernel_build_seconds"):
        assert f"# TYPE {name} histogram" in text


def _build(mod, **kw):
    return mod.build(job_id="j-0001", method="genEvmProof_SyncStepCompressed",
                     witness_digest="ab" * 32, attempts=1, submitted=1.0, admitted=1.5,
                     started=2.0, finished=5.0, queue_wait_s=0.5, events=[], peak_rss_mb=10.0,
                     result_digest="cd" * 32, **kw)


def test_manifest_keys_are_the_reference_s_with_kernels_for_compile():
    ref = _build(rmanifest, compile_events=[])
    got = _build(manifest, kernel_events=[])
    assert set(got) == set(ref) - {"compile"} | {"kernels"}
    for key in set(ref) - {"compile", "env", "modes", "lru_delta"}:
        assert got[key] == ref[key], key
    assert got["kernels"] == {"builds": 0, "seconds": 0.0, "by_fn": {}, "launches": {},
                              "events": []}
    assert manifest.from_bytes(manifest.to_bytes(got)) == got


def test_kernel_builds_and_launches_are_captured_per_job_and_entry_point():
    compilelog.install()
    compilelog.reset_for_tests()
    events = []
    with tracing.trace("build-probe") as tr, compilelog.capture(events):
        with compilelog.entry_point("outer"):
            KL.KERNELS["K4_ntt"].launches += 1
            with compilelog.entry_point("inner"):
                KL._built("field_kernels", 1.25)
                KL.KERNELS["K4_ntt"].launches += 2
    summary = compilelog.summarize(events)
    assert summary["builds"] == 1 and summary["seconds"] == 1.25
    assert summary["by_fn"] == {"inner": {"count": 1, "seconds": 1.25}}
    assert summary["launches"] == {"K4_ntt": 3}
    assert compilelog.launches_by_entry() == {"outer": {"K4_ntt": 1}, "inner": {"K4_ntt": 2}}
    assert "build/field_kernels" in tracing.phase_seconds(tr)
    hist = metrics.KERNEL_BUILD_SECONDS.labels(fn="inner").snapshot()
    assert hist["count"] >= 1


def test_report_cli_renders_and_gates(tmp_path, capsys):
    base = _build(manifest, kernel_events=[])
    cand = _build(manifest, kernel_events=[{"event": "build", "library": "msm_kernels",
                                            "fn": "prove/snark", "seconds": 9.0}])
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_bytes(manifest.to_bytes(base))
    pb.write_bytes(manifest.to_bytes(cand))
    assert report_cli.main(["report", str(pa)]) == 0
    out = capsys.readouterr().out
    assert "kernel builds : 0.000s across 0 library build(s)" in out
    assert report_cli.main(["report", str(pa), "--diff", str(pb), "--ci"]) == 3
    assert "CI REGRESSION: kernels.builds regressed: 0 -> 1" in capsys.readouterr().out


def test_utils_committee_poseidon_prints_the_reference_values(capsys):
    _, routes = chip_smoke.beacon_routes(SYNC, SPEC.MINIMAL)
    with chip_smoke.beacon_server(routes) as url:
        rcli.main(["--spec", "minimal", "utils", "committee-poseidon", "--beacon-api", url])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        cli.main(["utils", "committee-poseidon", "--beacon-api", url, "--spec", "minimal"])
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and set(got) == {"sync_period", "committee_ssz_root",
                                        "committee_poseidon"}


def test_faults_and_scrub_subcommands(tmp_path, capsys):
    cli.main(["faults", "--json"])
    sites = json.loads(capsys.readouterr().out)["sites"]
    rcli.main(["faults", "--json"])
    assert set(sites) == set(json.loads(capsys.readouterr().out)["sites"])
    q = jobs.JobQueue(lambda m, p: {"proof": "0x00", "instances": []},
                      journal_dir=str(tmp_path), scrub_interval=0)
    q.wait(q.submit("m", {"i": 1}), timeout=30)
    q.stop()
    orphan = q.store.write(b"nobody's")
    cli.main(["scrub", "--params-dir", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out)
    assert summary["expired"] == 1 and summary["corrupt"] == 0 and summary["live"] == 2
    assert not q.store.exists(orphan)


@pytest.mark.parametrize("argv", [
    ["rpc", "--spec", "testnet", "--k-step", "21", "--k-committee", "18", "--device", "cpu"],
    ["--spec", "testnet", "--device", "cpu", "rpc", "--k-step", "21", "--k-committee", "18"],
], ids=["flags-after", "flags-before"])
def test_rpc_command_line_of_the_readme(argv):
    """`--spec` and `--device` before or after the subcommand; --device
    defaults to cuda; the step's and committee's aggregation degrees."""
    a = cli._parser().parse_args(argv)
    assert (a.cmd, a.spec, a.device, a.k_step, a.k_committee) == ("rpc", "testnet", "cpu", 21, 18)
    assert cli._parser().parse_args(["rpc"]).device == "cuda"
    b = cli._parser().parse_args(argv + ["--k-agg-step", "21", "--k-agg-committee", "22"])
    assert (b.k_agg_step, b.k_agg_committee, b.k_agg) == (21, 22, 17)
