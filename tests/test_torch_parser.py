"""Text-file input: ``lightgbm_tpu_torch.io.parser.load_data_file`` and
``Dataset(path)`` against the JAX package on the same files.

- CSV, TSV, space-separated and LibSVM files; a header with ``name:``
  label / weight / ignore specs; index specs; ``.weight`` and ``.query``
  side files; NaN tokens (``na``, ``null``, ``NaN``, empty).  The port's
  ``X``, ``y``, weight, group and header names are byte for byte those of
  ``lightgbm_tpu.io.parser.load_data_file``, which on this machine parses
  CSV / TSV / LibSVM through its C++ parser (``lightgbm_tpu.native``),
  and byte for byte its Python path too (``native.available`` patched
  off in the test process), so both of the JAX package's paths agree
  with the port's ``float`` parse.
- ``Dataset("examples/binary_classification/binary.train")``: the mappers
  (``mappers_to_arrays``) and the bin matrix equal the JAX
  ``Dataset(path)``'s byte for byte, and one iteration with
  ``boost_from_average=false`` (binary gradients +-0.5, hessians 0.25:
  every sum exact) gives the JAX package's model text byte for byte.
- The file's labels, weights and header names fill what the caller did
  not pass; a missing file raises ``FileNotFoundError``; a binary cache
  (a zip file) names A1c; query groups (``group_column``, a ``.query``
  file) and ``.position`` files load (``group_column``'s groups are the
  JAX package's), and ``subset`` refuses a grouped dataset.
"""

import os
import zipfile

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.io import parser as PP

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "binary_classification",
    "binary.train")


@pytest.fixture(scope="module")
def JP():
    pytest.importorskip("lightgbm_tpu")
    from lightgbm_tpu.io import parser
    return parser


def _rows(seed=0, n=40, f=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f) * np.array([1.0, 1e-3, 1e4, 1.0, 3.0])[:f]
    X[rng.rand(n, f) < 0.1] = np.nan
    y = (rng.rand(n) > 0.5).astype(float)
    return X, y


def _token(v, nan_token):
    return nan_token if np.isnan(v) else "%.17g" % v


def _write_delimited(path, X, y, sep, header=None, nan_tokens=("nan",)):
    lines = [] if header is None else [sep.join(header)]
    for i, (row, lab) in enumerate(zip(X, y)):
        tok = nan_tokens[i % len(nan_tokens)]
        lines.append(sep.join(["%g" % lab]
                              + [_token(v, tok) for v in row]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _write_libsvm(path, X, y):
    with open(path, "w") as fh:
        for row, lab in zip(X, y):
            toks = ["%d:%.17g" % (j, v) for j, v in enumerate(row)
                    if v != 0 and not np.isnan(v)]
            fh.write(" ".join(["%g" % lab] + toks) + "\n")


def _same(a, b):
    """Byte for byte: None alike, else dtype, shape and bytes."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


#: name -> (writer kwargs, load_data_file kwargs)
CASES = {
    "csv": (dict(sep=","), {}),
    "tsv": (dict(sep="\t"), {}),
    "space": (dict(sep=" "), {}),
    "nan_tokens": (dict(sep=",", nan_tokens=("na", "null", "", "NaN")), {}),
    "tsv_nan_tokens": (dict(sep="\t", nan_tokens=("NA", "none", "")), {}),
    "header_names": (dict(sep=",", header=["y", "a", "b", "w", "c", "d"]),
                     dict(header=True, label_column="name:y",
                          weight_column="name:w", ignore_column="name:c")),
    "header_label_last": (dict(sep="\t", header=["t", "a", "b", "c", "d",
                                                 "e"]),
                          dict(header=True, label_column="0",
                               ignore_column="0,3")),
    "index_specs": (dict(sep=","), dict(weight_column="2",
                                        ignore_column="4")),
    "group_column": (dict(sep=","), dict(group_column="3")),
}


def _case_file(tmp_path, name):
    writer, kwargs = CASES[name]
    X, y = _rows(seed=len(name))
    if name in ("index_specs", "header_names"):
        X[:, 2] = np.abs(X[:, 2]) + 1.0           # a finite weight column
    if name == "group_column":
        X[:, 3] = np.repeat(np.arange(8), 5)      # query ids, grouped
    path = str(tmp_path / f"{name}.txt")
    _write_delimited(path, X, y, **writer)
    return path, kwargs


@pytest.mark.parametrize("name", sorted(CASES))
def test_delimited_file_byte_equal_to_jax(JP, tmp_path, name):
    path, kwargs = _case_file(tmp_path, name)
    want = JP.load_data_file(path, with_feature_names=True, **kwargs)
    got = PP.load_data_file(path, with_feature_names=True, **kwargs)
    for field, a, b in zip(("X", "y", "weight", "group", "names"), want,
                           got):
        assert _same(a, b), field


@pytest.mark.parametrize("name", ["csv", "nan_tokens", "header_names",
                                  "libsvm"])
def test_jax_python_parser_agrees_too(JP, tmp_path, monkeypatch, name):
    """The JAX package's Python path (its C++ parser switched off in this
    process) gives the same bytes as its native path and the port."""
    import lightgbm_tpu.native as native
    if name == "libsvm":
        X, y = _rows(seed=9)
        path, kwargs = str(tmp_path / "rows.svm"), {}
        _write_libsvm(path, X, y)
    else:
        path, kwargs = _case_file(tmp_path, name)
    fast = JP.load_data_file(path, **kwargs)
    monkeypatch.setattr(native, "available", lambda: False)
    slow = JP.load_data_file(path, **kwargs)
    got = PP.load_data_file(path, **kwargs)
    for field, a, b, c in zip(("X", "y", "weight", "group"), fast, slow,
                              got):
        assert _same(a, b), f"{field}: JAX native != JAX python"
        assert _same(b, c), f"{field}: port != JAX python"


def test_libsvm_and_side_files_byte_equal_to_jax(JP, tmp_path):
    X, y = _rows(seed=3)
    path = str(tmp_path / "rows.svm")
    _write_libsvm(path, X, y)
    np.savetxt(path + ".weight", np.linspace(0.5, 2.0, len(y)))
    np.savetxt(path + ".query", [10, 10, 20], fmt="%d")
    want = JP.load_data_file(path)
    got = PP.load_data_file(path)
    assert got[2] is not None and got[3] is not None
    for field, a, b in zip(("X", "y", "weight", "group"), want, got):
        assert _same(a, b), field
    with pytest.raises(ValueError, match="LibSVM"):
        PP.load_data_file(path, weight_column="1")


def test_example_dataset_bins_and_model_text_equal_jax():
    lgb = pytest.importorskip("lightgbm_tpu")
    from lightgbm_tpu.binning import mappers_to_arrays as jax_arrays

    from lightgbm_tpu_torch.binning import mappers_to_arrays
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 15,
              "boost_from_average": False, "min_data_in_leaf": 5}
    jd, pd = lgb.Dataset(EXAMPLE), lgt.Dataset(EXAMPLE)
    jt, pt = jd.construct(params), pd.construct(params)
    want, got = jax_arrays(jt.binned.mappers), mappers_to_arrays(
        pt.binned.mappers)
    assert want.keys() == got.keys()
    for key in want:
        assert _same(want[key], got[key]), key
    assert _same(jt.binned.bins, pt.binned.bins)
    assert _same(jd.label, pd.label) and pd.label.shape == (500,)
    jb = lgb.train(params, lgb.Dataset(EXAMPLE), 1)
    pb = lgt.train(params, lgt.Dataset(EXAMPLE), 1, device="cpu")
    assert pb.model_to_string() == jb.model_to_string()


def test_file_fills_what_the_caller_did_not_pass(tmp_path):
    X, y = _rows(seed=5, n=300, f=4)
    X = np.nan_to_num(X)
    path = str(tmp_path / "rows.csv")
    _write_delimited(path, X, y, sep=",", header=["lab", "a", "b", "c",
                                                  "d"])
    np.savetxt(path + ".weight", np.full(len(y), 2.0))
    params = {"objective": "binary", "verbosity": -1, "header": True,
              "min_data_in_leaf": 5}
    ds = lgt.Dataset(path, params=params)
    assert ds.num_data() == 300 and ds.num_feature() == 4
    np.testing.assert_array_equal(ds.get_label(), y)
    np.testing.assert_array_equal(ds.get_weight(), np.full(300, 2.0))
    bst = lgt.train(params, lgt.Dataset(path), 2, device="cpu")
    assert bst.feature_name() == ["a", "b", "c", "d"]
    # the caller's label and weight win over the file's
    ds2 = lgt.Dataset(path, label=1.0 - y, weight=np.ones(300),
                      params=params)
    ds2.construct()
    np.testing.assert_array_equal(ds2.get_label(), 1.0 - y)
    np.testing.assert_array_equal(ds2.get_weight(), np.ones(300))


def test_file_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        lgt.Dataset(str(tmp_path / "missing.tsv"))
    cache = str(tmp_path / "cache.bin")
    with zipfile.ZipFile(cache, "w") as zf:
        zf.writestr("magic.npy", b"")
    with pytest.raises(NotImplementedError, match="A1c"):
        lgt.Dataset(cache)
    X, y = _rows(seed=6)
    path = str(tmp_path / "rows.csv")
    _write_delimited(path, np.nan_to_num(X), y, sep=",")
    # query groups and positions load since slice 13 (ROADMAP A8.2):
    # group_column's query ids become group sizes, as in the JAX package
    jx = pytest.importorskip("lightgbm_tpu")
    want = jx.Dataset(path, params={"group_column": "1"})
    want.construct()
    got = lgt.Dataset(path, params={"group_column": "1"})
    got.construct()
    np.testing.assert_array_equal(got.get_group(), want.get_group())
    assert got.construct().group is not None
    np.savetxt(path + ".position", np.zeros(len(y)))
    ds = lgt.Dataset(path)
    ds.construct()
    np.testing.assert_array_equal(ds.position, np.zeros(len(y)))
    os.remove(path + ".position")
    np.savetxt(path + ".query", [len(y) - 1, 1], fmt="%d")
    ds = lgt.Dataset(path)
    np.testing.assert_array_equal(ds.construct().group, [len(y) - 1, 1])
    with pytest.raises(ValueError, match="query groups"):
        ds.subset([0, 1])


def test_timer_spans_match_jax_and_time_the_parse(tmp_path):
    """``utils/timer.py`` aggregates nested and repeated spans as the JAX
    package's ``Timer`` does (counts equal, stacks closed innermost
    first), and ``Dataset(path)`` times its parse and binning there."""
    pytest.importorskip("lightgbm_tpu")
    from lightgbm_tpu.utils.timer import Timer as JaxTimer

    from lightgbm_tpu_torch.utils.timer import Timer, global_timer
    timers = (JaxTimer(), Timer())
    for t in timers:
        t.start("a")
        t.start("a")
        t.stop("a")
        t.start("b")
        t.stop("b")
        t.stop("a")
        t.stop("c")                 # unmatched: ignored
    want, got = timers
    assert dict(got.counts) == dict(want.counts) == {"a": 2, "b": 1}
    assert [r[0] for r in got.snapshot()][0] == "a"
    X, y = _rows(seed=8)
    path = str(tmp_path / "rows.csv")
    _write_delimited(path, np.nan_to_num(X), y, sep=",")
    global_timer.reset()
    lgt.Dataset(path).construct()
    assert global_timer.counts["io/parse"] == 1
    assert global_timer.counts["dataset/bin"] == 1
    assert global_timer.durations["io/parse"] > 0
