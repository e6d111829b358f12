"""The port's telemetry gates and dashboard against the JAX package's.

* The golden catalog: ``EXPECTED_METRICS`` is the reference's less exactly
  ``query_compile_seconds`` (the port runs its programs eagerly), every
  other (type, unit, labels) equal; ``OPTIONAL_METRICS`` and
  ``EXPECTED_SPAN_NAMES`` equal.
* ``schema_check(device="cpu")`` passes, and ``overhead_check`` passes at
  the reference test's bound (4.0x, 10 ms, 15 iterations).
* The gate's two GPU guards: a dispatch to a plain version, a missing
  CUDA dispatch of B1 / B2, and an unfenced device span are caught.
* ``render_markdown`` gives the same string in both packages, for the
  port's demo snapshot and for the reference's; ``--prom`` names every
  family the demo records; the entry points take ``--device`` and refuse
  to run on the CPU unless asked.
"""

import contextlib
import io
import json

import pytest
import torch

import repro.obs.check as jcheck
import repro.obs.report as jreport
import repro_torch.obs.check as tcheck
import repro_torch.obs.report as treport
from repro_torch.obs import Telemetry


def test_golden_catalog_is_the_reference_less_compile_seconds():
    assert set(jcheck.EXPECTED_METRICS) - set(tcheck.EXPECTED_METRICS) == {
        "query_compile_seconds"}
    assert set(tcheck.EXPECTED_METRICS) <= set(jcheck.EXPECTED_METRICS)
    for name, spec in tcheck.EXPECTED_METRICS.items():
        assert spec == jcheck.EXPECTED_METRICS[name], name
    assert tcheck.OPTIONAL_METRICS == jcheck.OPTIONAL_METRICS
    assert tcheck.EXPECTED_SPAN_NAMES == jcheck.EXPECTED_SPAN_NAMES


@pytest.fixture(scope="module")
def port_snapshot():
    return tcheck.schema_check(verbose=False, device="cpu")


def test_schema_check_passes_on_cpu(port_snapshot):
    metrics = port_snapshot["metrics"]
    assert set(tcheck.EXPECTED_METRICS) <= set(metrics)
    assert "query_compile_seconds" not in metrics
    impls = {s["labels"]["impl"]
             for s in metrics["kernel_dispatch_total"]["series"]}
    assert impls == {"ref"}  # the CPU runs the plain versions
    json.dumps(port_snapshot)


def test_overhead_check_passes_at_the_reference_tests_bound():
    out = tcheck.overhead_check(bound_ratio=4.0, floor_s=10e-3, iters=15,
                                verbose=False, device="cpu")
    assert out["instrumented_s"] <= out["limit_s"]
    assert out["limit_s"] == pytest.approx(out["disabled_s"] * 4.0 + 10e-3)


def _series(kernel, impl, value=1.0):
    return {"labels": {"kernel": kernel, "impl": impl}, "value": value}


def test_gpu_dispatch_guard():
    ok = {"kernel_dispatch_total": {"series": [
        _series("fused_ingest", "cuda"), _series("route_rank", "cuda"),
        _series("fold_levels", "cuda")]}}
    assert tcheck._dispatch_problems(ok) == []
    silent = {"kernel_dispatch_total": {"series": [
        _series("fused_ingest", "cuda"), _series("route_rank", "cuda"),
        _series("fold_levels", "ref")]}}
    (msg,) = tcheck._dispatch_problems(silent)
    assert "impl=\"ref\"" in msg and "fold_levels" in msg
    missing = {"kernel_dispatch_total": {"series": [
        _series("fused_ingest", "cuda"), _series("route_rank", "cuda", 0.0)]}}
    (msg,) = tcheck._dispatch_problems(missing)
    assert "route_rank" in msg
    assert len(tcheck._dispatch_problems({})) == 2


def test_unfenced_device_span_guard():
    tel = Telemetry()
    with tel.tracer.span("request"):
        with tel.tracer.span("query.compute", kind="device") as s:
            s.fence(torch.zeros(2))
        with tel.tracer.span("route.device", kind="device"):
            pass
    with tel.tracer.span("ingest", kind="device"):
        pass
    assert tcheck._unfenced_device_spans(tel.tracer.roots()) == [
        "ingest", "route.device"]


def test_entry_points_take_device_and_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    assert tcheck.main(["bogus", "--device", "cpu"]) == 2
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcheck.main(["schema"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        treport.main(["--prom"])


@pytest.fixture(scope="module")
def reference_snapshot():
    return jreport.demo_snapshot()


@pytest.mark.parametrize("which", ["port_demo", "port_gate", "reference_demo"])
def test_render_markdown_identical(which, port_snapshot, reference_snapshot):
    snap = {
        "port_demo": lambda: treport.demo_snapshot(device="cpu"),
        "port_gate": lambda: port_snapshot,
        "reference_demo": lambda: reference_snapshot,
    }[which]()
    want = jreport.render_markdown(snap, title="t")
    got = treport.render_markdown(snap, title="t")
    assert got == want
    assert "## Counters & gauges" in got and "## Distributions" in got
    for name in snap["metrics"]:
        assert f"`{name}`" in got


def test_prom_names_every_family_and_json_renders(tmp_path):
    tel = Telemetry()
    snap = treport.demo_snapshot(tel, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert treport.main(["--prom", "--device", "cpu"]) == 0
    prom = buf.getvalue()
    assert snap["metrics"]
    for name, m in snap["metrics"].items():
        assert f"# TYPE {name} {m['type']}" in prom, name
    assert set(snap["metrics"]) <= set(tcheck.EXPECTED_METRICS)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert treport.main(["--json", str(path)]) == 0
    assert buf.getvalue().startswith("# Telemetry dashboard — snap.json")
    want = treport.render_markdown(snap, title="Telemetry dashboard — snap.json")
    assert buf.getvalue() == want + "\n"
