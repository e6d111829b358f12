"""The PyTorch port's stress harness against the JAX package's, on the CPU.

* At the reference test's configuration (``tests/test_stress.py``: seed 3,
  n 5, 4 shards, one wave of 2, 400 rows, one view verified a phase over
  256 rows) the port's counts, verified and spot-checked lists, emitted
  phase / wave / verify lines and summary equal the JAX harness's run,
  recorded in ``JAX_RECORDED*``; the port reports no failure.  The
  ``stress``-marked tests run the JAX harness live, once per module,
  with ``repro.core.preagg._TS_EMPTY`` rebound to the Python int (as
  ``torch_deploy_common.jax_families`` does per test), and hold it to
  that record: the same values, and its one flavour-parity failure,
  ``gen_v004``'s ``evo1``, a fault of the reference asserted as such so
  that a change on either side shows.
* The port alone: the N = 128 sweep at the defaults, and the CLI
  (``--smoke``, ``--force-fail``'s shrink and repro script, ``--repro``,
  ``--host-routing``) with the reference's exit codes.
* ``_repro_script`` renders the reference's text for the same view, with
  ``repro.stress`` -> ``repro_torch.stress``; ``StressReport.summary``
  renders the reference's text for the same report.
"""

import contextlib
import io
import re
import shlex

import pytest
import torch

import repro.stress.__main__ as jax_main
import repro.stress.harness as jax_harness
import repro_torch.stress.__main__ as port_main
import repro_torch.stress.harness as port_harness
from repro.stress.generate import gen_views as jax_gen_views
from repro_torch.stress.generate import gen_views

# tests/test_stress.py::test_harness_small_end_to_end
REF_CONFIG = dict(seed=3, n=5, num_shards=4, waves=1, wave_size=2, rows=400,
                  verify_samples=1, verify_rows=256)
# the JAX harness's run at REF_CONFIG (jax 0.9.0 on the CPU, `_TS_EMPTY`
# rebound): the record the tier-1 tests hold the port to.  Running it takes
# ~150 s of XLA compiles on one process (~350 s beside the other test
# workers), so the live run and its comparison are `stress`-marked:
# `pytest -m stress tests/test_torch_stress.py`
JAX_RECORDED = dict(
    deployed=5, waves_survived=1, parity_batches=2, requests=224,
    num_shards=4,
    verified=["gen_v000:preagg/shards=4", "gen_v001:preagg/shards=4/host"],
    spot_checked=["gen_v000", "gen_v001"],
)
JAX_RECORDED_PROTOCOL = [
    "phase 0: 3 live scenarios, 80 traffic rows",
    "  verify [PASS] view=gen_v000 v2 rows=256 features=6 "
    "(mode=preagg/shards=4)",
    "  wave 1: +2 views (backfill=False, refused-then-backfilled=0)",
    "phase 1: 5 live scenarios, 80 traffic rows",
    "  verify [PASS] view=gen_v001 v2 rows=256 features=3 "
    "(mode=preagg/shards=4/host)",
]
JAX_RECORDED_HEAD = (
    " stress seed=3 n=5 profile=default shards=4: 5 views deployed (1 "
    "hot-deploy waves), 224 requests , 2 flavour-parity probes, 2 verified "
    "(2 spot checks)"
)
# its one failure: the reference harness's own fault (ROADMAP.md, Queue C)
JAX_KNOWN_FAULT = [("gen_v004", "parity",
                    "feature 'evo1': fused != host oracle (phase 1)")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The harness issues many small operations: one intra-op thread runs
    them faster on the CPU than a pool shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(harness, repro_dir, **kw):
    lines = []
    rep = harness.run_stress(**REF_CONFIG, repro_dir=str(repro_dir),
                             emit=lines.append, **kw)
    return rep, lines


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_stress")
    rep, lines = _run(port_harness, d, device="cpu")
    return rep, lines, d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    import repro.core.preagg as jax_preagg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_preagg, "_TS_EMPTY", -2147483648)
        d = tmp_path_factory.mktemp("jax_stress")
        rep, lines = _run(jax_harness, d)
    return rep, lines, d


def _fields(rep):
    return {f: getattr(rep, f) for f in JAX_RECORDED}


def _protocol_lines(lines):
    """Phase and wave lines as emitted; verify lines without their error
    magnitudes (the two packages' float sums differ below the check's
    tolerance)."""
    out = []
    for ln in lines:
        if ln.startswith(("phase ", "  wave ")):
            out.append(ln)
        elif ln.startswith("  verify"):
            out.append(re.sub(r" max_abs=\S+ max_rel=\S+", "", ln))
    return out


def _head(rep):
    """The summary's first line without its verdict and its rate."""
    ln = rep.summary().splitlines()[0]
    return re.sub(r"\[(PASS|FAIL)\]|at \d+ req/s", "", ln)


@pytest.mark.parametrize("field", list(JAX_RECORDED))
def test_report_matches_jax(port_run, field):
    assert getattr(port_run[0], field) == JAX_RECORDED[field]


def test_emitted_protocol_matches_jax(port_run):
    got = _protocol_lines(port_run[1])
    assert got == JAX_RECORDED_PROTOCOL
    assert sum(ln.startswith("  wave ") for ln in got) == 1


def test_summary_matches_jax_for_the_run(port_run):
    assert _head(port_run[0]) == JAX_RECORDED_HEAD


def test_port_passes_at_the_reference_configuration(port_run):
    rep = port_run[0]
    assert rep.passed, rep.summary()
    # the two sampled verifies alternated routing flavours
    assert any(v.endswith("/host") for v in rep.verified)
    assert any(not v.endswith("/host") for v in rep.verified)
    assert not list(port_run[2].iterdir())  # no repro script on a pass


@pytest.mark.stress
def test_jax_harness_run_is_the_record(jax_run):
    """The JAX harness run live at REF_CONFIG (~150 s of XLA compiles on
    one process): its counts, lists, emitted protocol and summary are the
    record the tests above hold the port to, and its only failure is its
    known parity fault (it writes no repro script for it)."""
    rep, lines, d = jax_run
    assert _fields(rep) == JAX_RECORDED
    assert _protocol_lines(lines) == JAX_RECORDED_PROTOCOL
    assert _head(rep) == JAX_RECORDED_HEAD
    assert [(f.view, f.stage, f.detail) for f in rep.failures] == \
        JAX_KNOWN_FAULT
    assert not list(d.iterdir())


@pytest.mark.stress
def test_port_matches_the_live_jax_run(jax_run, port_run):
    assert _fields(port_run[0]) == _fields(jax_run[0])
    assert _protocol_lines(port_run[1]) == _protocol_lines(jax_run[1])
    assert _head(port_run[0]) == _head(jax_run[0])


@pytest.mark.parametrize("failures", [
    [],
    [("gen_v001", "verify", "forced failure (--force-fail)", 60,
      "./stress_repro_gen_v001.sh"),
     ("gen_v004", "parity", "feature 'evo1': fused != host oracle (phase 1)",
      None, None)],
    [("gen_v002", "deploy", "inexact hot-deploy migration (backfill=True): x",
      None, None),
     ("gen_v003", "spot", "feature 'f0': plane != dedicated store (phase 2)",
      120, None)],
])
def test_summary_text_equals_the_reference(failures):
    kw = dict(seed=7, n=128, profile="default", num_shards=8, deployed=128,
              waves_survived=2, requests=576, request_wall_s=1.5,
              deploy_wall_s=2.25, parity_batches=3,
              verified=["gen_v000:preagg/shards=8"],
              spot_checked=["gen_v000", "gen_v001"])
    reps = [
        h.StressReport(**kw, failures=[h.StressFailure(*f) for f in failures])
        for h in (jax_harness, port_harness)
    ]
    assert reps[1].summary() == reps[0].summary()
    assert reps[1].passed == reps[0].passed == (not failures)
    assert reps[1].qps == reps[0].qps


@pytest.mark.parametrize("device_routing", [True, False])
@pytest.mark.parametrize("seed,n,index", [(3, 5, 0), (3, 5, 4), (0, 16, 3),
                                          (0, 128, 77), (0, 128, 127)])
def test_repro_script_equals_the_reference(seed, n, index, device_routing):
    kw = dict(seed=seed, n=n, profile="default", data_rows=1200, rows=120,
              device_routing=device_routing,
              detail="max_abs=1.000e+00 max_rel=2.000e-01 mode=preagg")
    want = jax_harness._repro_script(view=jax_gen_views(seed, n)[index], **kw)
    got = port_harness._repro_script(view=gen_views(seed, n)[index], **kw)
    assert "python -m repro.stress --repro" in want
    assert got == want.replace("python -m repro.stress ",
                               "python -m repro_torch.stress ")


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port_main.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """``--smoke`` as it is, and with one view it verifies forced to fail
    (run from a temporary directory: the CLI writes its repro script to
    the working directory)."""
    ok = _cli(["--smoke", "--device", "cpu"])
    view = re.search(r"verify \[PASS\] view=(\S+)", ok[1]).group(1)
    d = tmp_path_factory.mktemp("smoke_force_fail")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        failed = _cli(["--smoke", "--force-fail", view, "--device", "cpu"])
    return ok, failed, view, d


def test_cli_full_sweep_n128_passes(tmp_path, monkeypatch):
    """The N = 128 sweep at the defaults (8 shards, 2 waves of 3, 1,200
    rows)."""
    monkeypatch.chdir(tmp_path)
    rc, out = _cli(["--n", "128", "--device", "cpu"])
    assert rc == 0, out
    last = out.strip().splitlines()[-1]
    assert re.fullmatch(
        r"\[PASS\] stress seed=0 n=128 profile=default shards=8: 128 views "
        r"deployed \(2 hot-deploy waves\), 576 requests at \d+ req/s, 3 "
        r"flavour-parity probes, 6 verified \(3 spot checks\)", last), last
    assert not list(tmp_path.iterdir())


def test_cli_smoke_passes(smoke_runs):
    rc, out = smoke_runs[0]
    assert rc == 0
    last = out.strip().splitlines()[-1]
    assert last.startswith("[PASS] stress seed=0 n=16 profile=default "
                           "shards=8: 16 views deployed (2 hot-deploy waves)")
    assert last.endswith("3 flavour-parity probes, 6 verified (3 spot checks)")


def test_cli_force_fail_shrinks_to_a_runnable_repro(smoke_runs):
    rc, out = smoke_runs[1]
    view, d = smoke_runs[2], smoke_runs[3]
    assert rc == 1
    fails = [ln for ln in out.splitlines() if ln.startswith("  [")]
    assert fails == [
        f"  [verify] {view}: forced failure (--force-fail) (shrunk to 60 "
        f"rows) repro: ./stress_repro_{view}.sh"
    ]
    script = (d / f"stress_repro_{view}.sh").read_text()
    assert [p.name for p in d.iterdir()] == [f"stress_repro_{view}.sh"]
    cmd = script.strip().splitlines()[-1]
    assert cmd.startswith("PYTHONPATH=src python -m repro_torch.stress --repro ")
    argv = shlex.split(cmd)[4:]
    assert argv[:3] == ["--repro", "--seed", "0"]
    assert f"--view {view}" in cmd and "--rows 60" in cmd
    rc, out = _cli(argv + ["--device", "cpu"])
    assert rc == 0 and out.startswith(f"[PASS] view={view} ")
    assert " rows=60 " in out


@pytest.mark.parametrize("host", [False, True])
def test_cli_repro_both_flavours(host):
    argv = ["--repro", "--seed", "0", "--n", "16", "--view", "gen_v003",
            "--data-rows", "1200", "--rows", "150", "--device", "cpu"]
    rc, out = _cli(argv + (["--host-routing"] if host else []))
    assert rc == 0
    assert out.startswith("[PASS] view=gen_v003 ")
    assert out.rstrip().endswith("/shards=8/host)" if host else "/shards=8)")


def test_run_repro_unknown_view_and_missing_view():
    with pytest.raises(KeyError, match="no generated view 'gen_v999'"):
        port_harness.run_repro(seed=0, n=16, profile="default",
                               view_name="gen_v999", data_rows=1200, rows=150,
                               device_routing=True, device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            port_main.main(["--repro", "--device", "cpu"])
    assert e.value.code == 2


def _help(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return buf.getvalue()


def test_cli_flags_match_the_reference():
    """Every flag, default and help text of ``python -m repro.stress``,
    plus ``--device``."""
    want = _help(jax_main.main)
    got = _help(port_main.main)
    assert "--device DEVICE" in got and "--device" not in want
    got = got.replace("python -m repro_torch.stress", "python -m repro.stress")
    got = got.replace(" [--device DEVICE]", "")
    got = re.sub(r"\n  --device DEVICE[^\n]*", "", got)
    # argparse wraps the usage lines by the length of the program's name
    assert got.split() == want.split()
