"""The port's circuit soundness auditor (spectre_tpu_torch/analysis/): the
finding and baseline mechanics, every circuit-audit rule with its seeded
mutation (an under-constrained cell, an over-degree expression, a copy
orphan, an unbound lookup table, dead columns, row-level holes), the
shipped baseline, the CLI's exit codes, and the port's findings equal to
the JAX auditor's, as dicts, on the same hand-built contexts and on the
TINY committee update (the file paths name each package's own module).
"""

import dataclasses
import json
import random

import pytest
import torch

from spectre_tpu.analysis import audit_context as ref_audit_context
from spectre_tpu.analysis import audit_rows as ref_audit_rows
from spectre_tpu.builder.context import Context as RContext
from spectre_tpu.builder.range_chip import RangeChip as RRangeChip
from spectre_tpu.plonk.constraint_system import CircuitConfig as RConfig
from spectre_tpu_torch.analysis import (Finding, Severity, audit_context, audit_rows,
                                        load_baseline, partition_findings, write_baseline)
from spectre_tpu_torch.analysis.circuit_audit import expression_degrees
from spectre_tpu_torch.builder.context import Context
from spectre_tpu_torch.builder.range_chip import RangeChip
from spectre_tpu_torch.plonk.constraint_system import CircuitConfig
from spectre_tpu_torch.plonk.expressions import all_expressions


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the tier-1 run has six workers
    on one machine, and timing-sensitive tests elsewhere share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _small_circuit(ctx_cls=Context, range_cls=RangeChip):
    """A clean little range-checked multiply circuit (either package's)."""
    random.seed(0)
    ctx = ctx_cls()
    rng = range_cls(lookup_bits=4)
    a = ctx.load_witness(3)
    b = ctx.load_witness(5)
    c = rng.gate.mul(ctx, a, b)
    rng.range_check(ctx, a, 4)
    ctx.expose_public(c)
    return ctx, ctx.auto_config(k=7, lookup_bits=4)


def _as_ref(findings) -> list:
    """The port's findings as the JAX auditor's dicts: the module paths of
    the one package named as the other's."""
    return [dict(f.to_dict(), file=f.file.replace("spectre_tpu_torch/", "spectre_tpu/"))
            for f in findings]


def _dicts(findings) -> list:
    return [f.to_dict() for f in findings]


class TestFindings:
    def test_key_defaults_and_partition(self):
        f1 = Finding("circuit", "CA-X", Severity.ERROR, "f.py", "obj", "m")
        assert f1.key == "CA-X:obj"
        f2 = Finding("circuit", "CA-Y", Severity.WARNING, "f.py", "obj", "m", key="CA-Y:obj:7")
        active, suppressed = partition_findings([f1, f2], {"CA-Y:obj:7": "accepted"})
        assert active == [f1] and suppressed == [f2]

    def test_baseline_roundtrip(self, tmp_path):
        path = str(tmp_path / "baseline.json")
        f = Finding("circuit", "CA-X", Severity.ERROR, "f.py", "k", "msg", key="CA-X:k:1")
        write_baseline([f], path, reason="test")
        assert "CA-X:k:1" in load_baseline(path)
        with open(path) as fh:
            assert json.load(fh)["suppressions"][0]["key"] == "CA-X:k:1"

    def test_severity_order(self):
        assert Severity.at_least("error", "warning")
        assert not Severity.at_least("warning", "error")


class TestCircuitAudit:
    def test_clean_circuit_has_no_findings(self):
        ctx, cfg = _small_circuit()
        assert audit_context(ctx, cfg, "clean") == []

    def test_flags_seeded_underconstrained_cell(self):
        """The mutation check: a witness cell no constraint touches."""
        ctx, _ = _small_circuit()
        ctx.load_witness(999)
        rules = [f.rule for f in audit_context(ctx, ctx.auto_config(k=7, lookup_bits=4),
                                               "seeded")]
        assert "CA-UNDERCONSTRAINED" in rules

    def test_flags_seeded_degree_violation(self):
        """An injected expression of column-degree 5 > budget 4."""
        ctx, cfg = _small_circuit()

        def evil(cfg_, c, beta, gamma):
            yield from all_expressions(cfg_, c, beta, gamma)
            v = c.var(("adv", 0), 0)
            yield c.mul(c.mul(c.mul(c.mul(v, v), v), v), v)

        assert any(f.rule == "CA-DEGREE" for f in audit_context(ctx, cfg, "deg",
                                                                expressions_fn=evil))
        assert all(d <= cfg.max_expr_degree for d in expression_degrees(cfg))

    def test_real_expression_degrees_within_budget(self):
        # the wide-SHA region's identities included (selector x bit cubics)
        cfg = CircuitConfig(k=10, num_advice=1, num_lookup_advice=1, num_fixed=1,
                            lookup_bits=8, num_sha_slots=1)
        degs = expression_degrees(cfg)
        assert degs and max(degs) <= cfg.max_expr_degree == 4

    def test_flags_copy_orphan(self):
        ctx, cfg = _small_circuit()
        ctx.copies += ((10 ** 6) << 3, 0 << 3)
        assert any(f.rule == "CA-COPY-ORPHAN" for f in audit_context(ctx, cfg, "orphan"))

    def test_flags_unbound_lookup_table(self):
        ctx, _ = _small_circuit()
        ctx.lkp_streams.setdefault("nibble_op", []).append(5)
        cfg = CircuitConfig(k=7, num_advice=2, num_lookup_advice=1, num_fixed=1,
                            lookup_bits=4, lookup_tables=("range",))
        assert any(f.rule == "CA-TABLE-UNBOUND" for f in audit_context(ctx, cfg, "tbl"))

    def test_flags_dead_columns(self):
        ctx = Context()
        ctx.expose_public(ctx.load_witness(5))
        cfg = CircuitConfig(k=7, num_advice=1, num_lookup_advice=1, num_fixed=1,
                            lookup_bits=4)
        rules = [f.rule for f in audit_context(ctx, cfg, "dead")]
        assert "CA-DEAD-SELECTOR" in rules and "CA-DEAD-FIXED" in rules


def _unbound_row(cfg):
    def mutate(placement, selectors, copies):
        placement[max(placement)] = (0, cfg.usable_rows - 2)
        return placement, selectors, copies
    return mutate


def _dead_selector_row(cfg):
    def mutate(placement, selectors, copies):
        selectors[0][cfg.usable_rows - 8] = 1
        return placement, selectors, copies
    return mutate


class TestRowAudit:
    def test_clean_circuit_rows_clean(self):
        ctx, cfg = _small_circuit()
        assert audit_rows(ctx, cfg, "clean") == []

    def test_flags_seeded_row_unbound(self):
        """A placed cell drifted to a row no gate window covers and no copy
        endpoint binds: a free witness row."""
        ctx, cfg = _small_circuit()
        fs = audit_rows(ctx, cfg, "rowmut", mutate=_unbound_row(cfg))
        assert any(f.rule == "CA-ROW-UNBOUND" and f.severity == Severity.ERROR for f in fs)

    def test_flags_seeded_dead_selector_row(self):
        ctx, cfg = _small_circuit()
        fs = audit_rows(ctx, cfg, "deadsel", mutate=_dead_selector_row(cfg))
        assert any(f.rule == "CA-ROW-DEAD-SELECTOR" for f in fs)

    def test_flags_stale_sha_slot_selectors(self):
        ctx, cfg = _small_circuit()
        fs = audit_rows(ctx, dataclasses.replace(cfg, num_sha_slots=1), "shastale")
        assert any(f.rule == "CA-ROW-DEAD-SELECTOR" and ":sha" in f.key for f in fs)

    def test_row_mutate_does_not_poison_caches(self):
        ctx, cfg = _small_circuit()

        def mutate(placement, selectors, copies):
            placement[max(placement)] = (0, cfg.usable_rows - 2)
            selectors[0][0] = 0
            return placement, selectors, copies

        assert audit_rows(ctx, cfg, "m", mutate=mutate) != []
        assert audit_rows(ctx, cfg, "clean-again") == []

    def test_audit_context_threads_row_mutate(self):
        ctx, cfg = _small_circuit()
        rules = [f.rule for f in audit_context(ctx, cfg, "threaded",
                                               row_mutate=_unbound_row(cfg))]
        assert "CA-ROW-UNBOUND" in rules


# -- the port's findings against the JAX auditor's --------------------------------

def _pair():
    return _small_circuit(), _small_circuit(RContext, RRangeChip)


def _loose(ctx, rctx):
    ctx.load_witness(999)
    rctx.load_witness(999)


def _orphans(ctx, rctx):
    ctx.copies += ((10 ** 6) << 3, 0, 7 << 3, (10 ** 5) << 3)
    rctx.copies.append((("adv", 10 ** 6), ("adv", 0)))
    rctx.copies.append((("adv", 7), ("adv", 10 ** 5)))


def _unbound_table(ctx, rctx):
    ctx.lkp_streams.setdefault("nibble_op", []).append(5)
    rctx.lkp_streams.setdefault("nibble_op", []).append(5)


SEEDED = {"clean": None, "loose": _loose, "orphans": _orphans, "table": _unbound_table}


@pytest.mark.parametrize("seed", list(SEEDED))
def test_findings_equal_the_reference(seed):
    (ctx, _), (rctx, _) = _pair()
    if SEEDED[seed] is not None:
        SEEDED[seed](ctx, rctx)
    cfg = ctx.auto_config(k=7, lookup_bits=4)
    rcfg = rctx.auto_config(k=7, lookup_bits=4)
    if seed == "table":
        cfg = CircuitConfig(k=7, num_advice=2, num_lookup_advice=1, num_fixed=1,
                            lookup_bits=4, lookup_tables=("range",))
        rcfg = RConfig(k=7, num_advice=2, num_lookup_advice=1, num_fixed=1,
                       lookup_bits=4, lookup_tables=("range",))
    got = audit_context(ctx, cfg, seed)
    assert _as_ref(got) == _dicts(ref_audit_context(rctx, rcfg, seed))
    assert (got == []) == (seed == "clean")


def test_degree_and_dead_column_findings_equal_the_reference():
    (ctx, cfg), (rctx, rcfg) = _pair()

    def evil(expressions):
        def gen(cfg_, c, beta, gamma):
            yield from expressions(cfg_, c, beta, gamma)
            v = c.var(("adv", 0), 0)
            yield c.mul(c.mul(c.mul(c.mul(v, v), v), v), v)
        return gen

    from spectre_tpu.plonk.expressions import all_expressions as ref_all
    assert _as_ref(audit_context(ctx, cfg, "deg", expressions_fn=evil(all_expressions))) == \
        _dicts(ref_audit_context(rctx, rcfg, "deg", expressions_fn=evil(ref_all)))
    ctx, rctx = Context(), RContext()
    ctx.expose_public(ctx.load_witness(5))
    rctx.expose_public(rctx.load_witness(5))
    cfg = CircuitConfig(k=7, num_advice=1, num_lookup_advice=1, num_fixed=1, lookup_bits=4)
    rcfg = RConfig(k=7, num_advice=1, num_lookup_advice=1, num_fixed=1, lookup_bits=4)
    got = audit_context(ctx, cfg, "dead")
    assert got and _as_ref(got) == _dicts(ref_audit_context(rctx, rcfg, "dead"))


@pytest.mark.parametrize("mutation", ["unbound", "dead", "sha"])
def test_row_findings_equal_the_reference(mutation):
    (ctx, cfg), (rctx, rcfg) = _pair()
    if mutation == "sha":
        got = audit_rows(ctx, dataclasses.replace(cfg, num_sha_slots=1), "sha")
        want = ref_audit_rows(rctx, dataclasses.replace(rcfg, num_sha_slots=1), "sha")
    else:
        mk = _unbound_row if mutation == "unbound" else _dead_selector_row
        got = audit_rows(ctx, cfg, mutation, mutate=mk(cfg))
        want = ref_audit_rows(rctx, rcfg, mutation, mutate=mk(rcfg))
    assert got and _as_ref(got) == _dicts(want)


@pytest.fixture(scope="module")
def committee():
    """The TINY committee update's context in both packages (seconds)."""
    from spectre_tpu.analysis.circuits import build_committee_update as ref_build
    from spectre_tpu_torch.analysis.circuits import build_committee_update
    return build_committee_update(device="cpu"), ref_build()


def test_committee_findings_equal_the_reference(committee):
    """Clean in both, and one loose witness cell appended to both gives the
    same findings (laid out at k=18: a layout is memoized on its config)."""
    (ctx, cfg, name), (rctx, rcfg, rname) = committee
    assert name == rname
    assert audit_context(ctx, cfg, name) == [] == ref_audit_context(rctx, rcfg, rname)
    ctx.load_witness(12345)
    rctx.load_witness(12345)
    cfg2 = ctx.auto_config(k=18, lookup_bits=cfg.lookup_bits)
    rcfg2 = rctx.auto_config(k=18, lookup_bits=rcfg.lookup_bits)
    got = audit_context(ctx, cfg2, name)
    assert got and _as_ref(got) == _dicts(ref_audit_context(rctx, rcfg2, rname))


class TestShippedBaseline:
    def test_repo_baseline_still_empty(self):
        """The shipped baseline must stay empty: a suppression sneaking in
        would silently accept a circuit-soundness finding."""
        import os

        import spectre_tpu_torch.analysis as A
        with open(os.path.join(os.path.dirname(A.__file__), "baseline.json")) as fh:
            assert json.load(fh) == {"suppressions": []}

    def test_new_passes_need_no_baseline(self):
        """The row auditor holds the committee update clean against the
        empty baseline."""
        from spectre_tpu_torch.analysis.circuits import AUDIT_CIRCUITS
        ctx, cfg, name = AUDIT_CIRCUITS["committee_update"](device="cpu")
        assert audit_rows(ctx, cfg, name) == []


@pytest.mark.slow
@pytest.mark.parametrize("target", ["sync_step", "aggregation"])
def test_large_targets_audit_clean(target):
    """The TINY step (52 s on the CPU, its build 21 s) and the aggregation
    of a k=10 inner proof (70 s, its build 64 s): clean against the empty
    baseline."""
    from spectre_tpu_torch.analysis.circuits import AUDIT_CIRCUITS
    ctx, cfg, name = AUDIT_CIRCUITS[target](device="cpu")
    assert audit_context(ctx, cfg, name) == []


class TestCLI:
    def test_unported_engines_exit_nonzero(self, capsys):
        from spectre_tpu_torch.analysis.__main__ import main
        for engine, word in (("kernel", "jaxprs"), ("trace", "trace caches")):
            assert main(["--engine", engine]) == 2
            err = capsys.readouterr().err.strip().splitlines()
            assert len(err) == 1 and word in err[0] and "no port" in err[0]

    def test_circuit_engine_json_payload(self, tmp_path):
        from spectre_tpu_torch.analysis.__main__ import main
        out = str(tmp_path / "findings.json")
        assert main(["--engine", "circuit", "--circuits", "committee_update",
                     "--device", "cpu", "--json", out, "-q"]) == 0
        data = json.load(open(out))
        assert data["active"] == [] and data["suppressed"] == []
        assert [p["name"] for p in data["passes"]] == ["circuit committee_update:tiny"]
        assert data["roots"] == {"circuits": 1}

    def test_fail_on_gates_exit_code(self, tmp_path, monkeypatch):
        """A seeded finding flips the exit code unless baselined."""
        from spectre_tpu_torch.analysis import __main__ as CLI
        from spectre_tpu_torch.analysis import circuits

        def seeded(device=None):
            ctx, cfg = _small_circuit()
            ctx.load_witness(999)
            return ctx, ctx.auto_config(k=7, lookup_bits=4), "seeded"

        monkeypatch.setitem(circuits.AUDIT_CIRCUITS, "seeded", seeded)
        empty = str(tmp_path / "empty.json")
        assert CLI.main(["--circuits", "seeded", "--baseline", empty, "-q"]) == 1
        assert CLI.main(["--circuits", "seeded", "--baseline", empty, "-q",
                         "--fail-on", "never"]) == 0
        bl = str(tmp_path / "bl.json")
        assert CLI.main(["--circuits", "seeded", "--baseline", bl, "--write-baseline",
                         "-q"]) == 0
        assert CLI.main(["--circuits", "seeded", "--baseline", bl, "-q"]) == 0
