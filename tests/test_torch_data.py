"""The port's data layer against the JAX package's.

* The synthetic streams: for the same ``np.random.Generator`` state every
  column (and ``fraud_stream``'s labels) is byte-identical to the
  reference's — ``stress_stream`` on both sides of its ``t_max`` branch,
  all five tables; ``reco_stream``; ``lm_stream``'s first batches;
  ``multitable_stream``; and the :data:`STRESS_DB` schemas.
* The loaders (``validate``, ``load_csv``, ``load_npz``, ``insert_rows``,
  ``load_table``) on the same CSV text / npz / rows: the same columns,
  dtypes and bytes; the same refusals with the same messages.
* A float32 column written as ``repr(float(v))`` loads back bit for bit.
"""

import dataclasses
import io

import numpy as np
import pytest

import repro.data as jdata
import repro.data.ingest as jingest
import repro.data.synthetic as jsyn
import repro_torch.data as tdata
import repro_torch.data.ingest as tingest
import repro_torch.data.synthetic as tsyn


def _assert_cols_identical(want, got, where=""):
    assert list(want) == list(got), where
    for c in want:
        w, g = np.asarray(want[c]), np.asarray(got[c])
        assert w.dtype == g.dtype, f"{where}{c}: {w.dtype} != {g.dtype}"
        assert w.shape == g.shape, f"{where}{c}"
        assert w.tobytes() == g.tobytes(), f"{where}{c}: bytes differ"


def _schema_fields(schema):
    return dataclasses.astuple(schema)


# -- streams -----------------------------------------------------------------


def test_all_exports_are_the_references_plus_fraud_transactions():
    assert set(tsyn.__all__) == set(jsyn.__all__) | {"fraud_transactions"}
    assert set(tdata.__all__) == set(jdata.__all__)
    assert set(tingest.__all__) == set(jingest.__all__)


def test_schemas_equal():
    for name in ("FRAUD_SCHEMA", "RECO_SCHEMA"):
        assert _schema_fields(getattr(tsyn, name)) == _schema_fields(
            getattr(jsyn, name))
    for db in ("MULTITABLE_DB", "STRESS_DB"):
        w, g = getattr(jsyn, db), getattr(tsyn, db)
        assert w.name == g.name
        assert [_schema_fields(t) for t in w.tables] == [
            _schema_fields(t) for t in g.tables]


@pytest.mark.parametrize("seed, n, kw", [
    (0, 200, {}),                                  # n <= t_max: rng.choice
    (3, 1, {}),
    (5, 4_000, dict(num_entities=7, num_items=3, t_max=1_000)),  # n > t_max
    (9, 3_800, dict(t_max=3_800)),                 # n == t_max
])
def test_stress_stream_identical(seed, n, kw):
    want = jsyn.stress_stream(np.random.default_rng(seed), n, **kw)
    got = tsyn.stress_stream(np.random.default_rng(seed), n, **kw)
    assert list(want) == list(got) == [
        "events", "refunds", "clicks", "profiles", "items"]
    for t in want:
        _assert_cols_identical(want[t], got[t], f"{t}.")


@pytest.mark.parametrize("seed, n, kw", [
    (0, 500, {}), (4, 1_200, dict(num_cards=8, t_max=9_000)),
])
def test_fraud_stream_identical_with_labels(seed, n, kw):
    wc, wl = jsyn.fraud_stream(np.random.default_rng(seed), n, **kw)
    gc, gl = tsyn.fraud_stream(np.random.default_rng(seed), n, **kw)
    _assert_cols_identical(wc, gc)
    assert wl.dtype == gl.dtype and wl.tobytes() == gl.tobytes()
    assert 0 < gl.sum() < n  # the planted rule labels some rows


@pytest.mark.parametrize("seed, n, kw", [
    (7, 6_000, dict(num_users=128)), (1, 10, dict(num_products=3)),
])
def test_reco_stream_identical(seed, n, kw):
    _assert_cols_identical(
        jsyn.reco_stream(np.random.default_rng(seed), n, **kw),
        tsyn.reco_stream(np.random.default_rng(seed), n, **kw))


@pytest.mark.parametrize("batch, seq_len, vocab", [(2, 32, 256), (3, 17, 50)])
def test_lm_stream_first_batches_identical(batch, seq_len, vocab):
    want = jsyn.lm_stream(np.random.default_rng(2), batch, seq_len, vocab)
    got = tsyn.lm_stream(np.random.default_rng(2), batch, seq_len, vocab)
    for _ in range(3):
        w, g = next(want), next(got)
        _assert_cols_identical(w, g)
        assert g["tokens"].shape == (batch, seq_len)
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def test_multitable_stream_identical():
    want = jsyn.multitable_stream(np.random.default_rng(11), 3_000)
    got = tsyn.multitable_stream(np.random.default_rng(11), 3_000)
    for t in want:
        _assert_cols_identical(want[t], got[t], f"{t}.")


# -- loaders -----------------------------------------------------------------

SCHEMA_KW = dict(name="orders", key="user", ts="ts",
                 numeric=("price", "qty"), categorical=("product",))


def _schemas():
    from repro.core.storage import TableSchema as J
    from repro_torch.core.storage import TableSchema as T

    return J(**SCHEMA_KW), T(**SCHEMA_KW)


def _rows(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        user=rng.integers(0, 8, n),
        ts=np.sort(rng.integers(0, 10_000, n)),
        price=rng.gamma(2.0, 30.0, n).astype(np.float32),
        qty=rng.integers(1, 5, n).astype(np.float64),
        product=rng.integers(0, 10, n),
    )


def write_csv(cols) -> str:
    """CSV text of a columns dict: floats as ``repr(float(v))`` (a float32's
    exact float64 widening), ints as ``str``."""
    names = list(cols)
    text = []
    for c in names:
        v = np.asarray(cols[c])
        text.append(list(map(repr, v.astype(np.float64).tolist()))
                    if v.dtype.kind == "f" else list(map(str, v.tolist())))
    return ",".join(names) + "\n" + "\n".join(map(",".join, zip(*text))) + "\n"


@pytest.mark.parametrize("via", ["stringio", "path"])
def test_load_csv_identical_and_round_trips(via, tmp_path):
    js, ts = _schemas()
    cols = _rows()
    text = write_csv(cols)
    if via == "path":
        p = tmp_path / "orders.csv"
        p.write_text(text)
        want, got = jingest.load_csv(p, js), tingest.load_csv(str(p), ts)
    else:
        want = jingest.load_csv(io.StringIO(text), js)
        got = tingest.load_csv(io.StringIO(text), ts)
    _assert_cols_identical(want, got)
    assert got["user"].dtype == np.int32 and got["product"].dtype == np.int32
    assert got["price"].dtype == np.float32
    # float32 columns come back bit for bit
    assert got["price"].tobytes() == cols["price"].tobytes()


def test_load_csv_parses_through_float64():
    js, ts = _schemas()
    # a decimal that float32 cannot hold, and ints written as floats
    text = "user,ts,price,qty,product\n3.0,17,0.1,2.5,4\n1,18,1e-46,3,7.0\n"
    want = jingest.load_csv(io.StringIO(text), js)
    got = tingest.load_csv(io.StringIO(text), ts)
    _assert_cols_identical(want, got)
    assert got["price"][0] == np.float32(0.1)


def test_load_npz_identical(tmp_path):
    js, ts = _schemas()
    p = tmp_path / "orders.npz"
    np.savez(p, **_rows(), extra=np.zeros(50))
    want, got = jingest.load_npz(p, js), tingest.load_npz(p, ts)
    _assert_cols_identical(want, got)
    assert "extra" not in got


@pytest.mark.parametrize("into", [False, True])
def test_insert_rows_identical(into):
    js, ts = _schemas()
    rows = [dict(user=1, ts=5, price=2.5, qty=1, product=3),
            dict(user=0, ts=9, price=7.25, qty=2, product=1)]
    base = _rows(4)
    want = jingest.insert_rows(rows, js,
                               into=jingest.validate(js, base) if into else None)
    got = tingest.insert_rows(rows, ts,
                              into=tingest.validate(ts, base) if into else None)
    _assert_cols_identical(want, got)
    assert len(got["user"]) == (6 if into else 2)


@pytest.mark.parametrize("fmt", ["csv", "npz", "rows"])
def test_load_table_dispatch_identical(fmt, tmp_path):
    js, ts = _schemas()
    cols = _rows(20, seed=3)
    if fmt == "csv":
        p = tmp_path / "t.csv"
        p.write_text(write_csv(cols))
        src = p
    elif fmt == "npz":
        src = tmp_path / "t.npz"
        np.savez(src, **cols)
    else:
        src = [{c: v[i] for c, v in cols.items()} for i in range(20)]
    _assert_cols_identical(jingest.load_table(src, js, fmt),
                           tingest.load_table(src, ts, fmt))


def _refusal(fn_j, fn_t, exc):
    with pytest.raises(exc) as wj:
        fn_j()
    with pytest.raises(exc) as wt:
        fn_t()
    assert str(wt.value) == str(wj.value)
    return str(wt.value)


@pytest.mark.parametrize("fmt", ["hive", "parquet", "sql"])
def test_backends_refused_as_the_reference(fmt):
    js, ts = _schemas()
    msg = _refusal(lambda: jingest.load_table("x", js, fmt),
                   lambda: tingest.load_table("x", ts, fmt),
                   NotImplementedError)
    assert fmt in msg and "csv" in msg


def test_unknown_format_and_bad_columns_refused_as_the_reference():
    js, ts = _schemas()
    msg = _refusal(lambda: jingest.load_table("x", js, "xlsx"),
                   lambda: tingest.load_table("x", ts, "xlsx"), ValueError)
    assert "unknown format" in msg
    msg = _refusal(lambda: jingest.load_csv(io.StringIO("user,ts\n"), js),
                   lambda: tingest.load_csv(io.StringIO("user,ts\n"), ts),
                   ValueError)
    assert msg == "empty CSV"
    short = {c: v for c, v in _rows(5).items() if c != "qty"}
    msg = _refusal(lambda: jingest.validate(js, short),
                   lambda: tingest.validate(ts, short), ValueError)
    assert "missing columns ['qty']" in msg
    ragged = dict(_rows(5), price=np.zeros(4, np.float32))
    msg = _refusal(lambda: jingest.validate(js, ragged),
                   lambda: tingest.validate(ts, ragged), ValueError)
    assert "has 4 rows, key has 5" in msg
