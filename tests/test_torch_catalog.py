"""The port's stress generator, scenario registry and feature catalog
against the JAX package's.

* ``view_fingerprint`` of ``gen_views`` equal to the reference's at
  (11, 32), (0, 128) and (3, 12) under every profile, and equal in a fresh
  interpreter that imports only the port; the knobs, the census and its
  markdown equal.
* ``SCENARIOS`` / ``GENERATED``: every field but ``run`` equal, each
  view's ``describe()`` byte-identical.
* ``build_catalog()`` equal to the reference's (itself the committed
  ``docs/CATALOG.md``) after exactly two substitutions: the header's two
  names and the ``Run:`` lines.  ``--check`` passes on the committed
  ``docs/CATALOG_TORCH.md`` and exits 1 on a stale copy.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.catalog as jcat
import repro.scenarios as jscen
import repro.stress.generate as jgen
import repro_torch.catalog as tcat
import repro_torch.scenarios as tscen
import repro_torch.stress.generate as tgen

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = [(11, 32), (0, 128), (3, 12)]


@pytest.mark.parametrize("profile", sorted(jgen.PROFILES))
@pytest.mark.parametrize("seed, n", SHAPES)
def test_view_fingerprint_equal(seed, n, profile):
    want = jgen.view_fingerprint(jgen.gen_views(seed, n, profile))
    got = tgen.view_fingerprint(tgen.gen_views(seed, n, profile))
    assert got == want


def test_view_fingerprint_equal_in_a_fresh_process():
    code = (
        "import sys\n"
        "from repro_torch.stress.generate import gen_views, view_fingerprint\n"
        "print(view_fingerprint(gen_views(11, 32, 'relational')))\n"
        "assert not any(m == 'jax' or m.startswith('repro.') "
        "for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    want = jgen.view_fingerprint(jgen.gen_views(11, 32, "relational"))
    assert res.stdout.strip() == want


def test_profiles_and_constants_equal():
    assert tgen.PROFILES.keys() == jgen.PROFILES.keys()
    for k in jgen.PROFILES:
        assert (tgen.PROFILES[k].__dict__ == jgen.PROFILES[k].__dict__)
    assert (tgen.NUM_ENTITIES, tgen.NUM_ITEMS, tgen.T_MAX) == (
        jgen.NUM_ENTITIES, jgen.NUM_ITEMS, jgen.T_MAX)
    assert set(tgen.__all__) == set(jgen.__all__)
    for stage in ("views", "knobs", "data"):
        a = jgen.stress_rng(4, 16, "default", stage).integers(0, 2**31, 8)
        b = tgen.stress_rng(4, 16, "default", stage).integers(0, 2**31, 8)
        assert a.tolist() == b.tolist()
    assert [repr(w.key) for w in tgen.shared_pool()] == [
        repr(w.key) for w in jgen.shared_pool()]


@pytest.mark.parametrize("seed, n", SHAPES)
def test_store_kwargs_and_knob_filter_equal(seed, n):
    want = jgen.gen_store_kwargs(seed, n)
    got = tgen.gen_store_kwargs(seed, n)
    assert got == want
    jv, tv = jgen.gen_views(seed, n)[:3], tgen.gen_views(seed, n)[:3]
    assert tgen.filter_table_knobs(got, tv) == jgen.filter_table_knobs(want, jv)


@pytest.mark.parametrize("seed, n, profile", [(0, 128, "default"),
                                              (3, 12, "windows"),
                                              (11, 32, "relational")])
def test_summary_and_markdown_equal(seed, n, profile):
    jv, tv = jgen.gen_views(seed, n, profile), tgen.gen_views(seed, n, profile)
    assert tgen.summarize_views(tv) == jgen.summarize_views(jv)
    kw = dict(seed=seed, n=n, profile=profile)
    assert tgen.render_summary_md(tv, **kw) == jgen.render_summary_md(jv, **kw)


def test_unknown_profile_refused():
    with pytest.raises(KeyError, match="unknown profile"):
        tgen.gen_views(0, 4, "nope")


def test_registry_fields_equal():
    assert list(tscen.SCENARIOS) == list(jscen.SCENARIOS)
    for name, want in jscen.SCENARIOS.items():
        got = tscen.SCENARIOS[name]
        for f in ("name", "title", "description", "hot_deployed", "exported"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert got.run.startswith("PYTHONPATH=src python -m repro_torch.")
        jv, tv = want.views(), got.views()
        assert [v.describe() for v in tv] == [v.describe() for v in jv]
    assert list(tscen.GENERATED) == list(jscen.GENERATED)
    for name, want in jscen.GENERATED.items():
        got = tscen.GENERATED[name]
        for f in ("name", "title", "description", "seed", "n", "profile"):
            assert getattr(got, f) == getattr(want, f), (name, f)
    assert set(tscen.__all__) == set(jscen.__all__)


def _substituted(reference_md: str) -> str:
    """The reference's catalog with the two documented substitutions."""
    out = reference_md.replace(
        "`python -m repro.catalog` from `src/repro/scenarios.py`",
        "`python -m repro_torch.catalog` from `src/repro_torch/scenarios.py`",
    ).replace(
        "CI runs `python -m repro.catalog --check`",
        "CI runs `python -m repro_torch.catalog --check`",
    )
    runs = {s.run: tscen.SCENARIOS[k].run for k, s in jscen.SCENARIOS.items()}
    runs.update({s.run: tscen.GENERATED[k].run
                 for k, s in jscen.GENERATED.items()})
    for old, new in runs.items():
        out = out.replace(f"Run: `{old}`", f"Run: `{new}`")
    return out


@pytest.fixture(scope="module")
def catalogs():
    return jcat.build_catalog(), tcat.build_catalog()


def test_catalog_equals_reference_up_to_the_two_substitutions(catalogs):
    want, got = catalogs
    assert got == _substituted(want)
    # exactly the header's two lines and the six Run: lines differ
    diff = [(a, b) for a, b in zip(want.splitlines(), got.splitlines())
            if a != b]
    assert len(want.splitlines()) == len(got.splitlines())
    assert len(diff) == 2 + len(jscen.SCENARIOS) + len(jscen.GENERATED)
    assert all(b.startswith(("Run: ", "> ")) for _, b in diff)
    assert tcat.build_catalog() == got  # no wall-clock leaks


def test_committed_catalog_is_fresh(catalogs):
    assert tcat.CATALOG_PATH.name == "CATALOG_TORCH.md"
    assert tcat.CATALOG_PATH.read_text() == catalogs[1]
    assert tcat.main(["--check"]) == 0


def test_check_exits_1_on_a_stale_copy(tmp_path, catalogs, capsys):
    out = tmp_path / "CATALOG_TORCH.md"
    assert tcat.main(["--check", "--out", str(out)]) == 1  # missing
    assert tcat.main(["--out", str(out)]) == 0
    assert out.read_text() == catalogs[1]
    assert tcat.main(["--check", "--out", str(out)]) == 0
    out.write_text(catalogs[1].replace("fraud_features", "fraud_feature", 1))
    assert tcat.main(["--check", "--out", str(out)]) == 1
    assert "STALE" in capsys.readouterr().err
