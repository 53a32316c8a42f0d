"""Text data files: CSV, TSV, space-separated and LibSVM, with the format
sniffed from the first lines.

The port's copy of the JAX package's ``io/parser.py`` (reference
``Parser::CreateParser``, ``src/io/parser.cpp``), its Python path: the
label column by index or ``name:<col>``, in-data weight / query / ignored
columns, the ``<data>.weight`` / ``<data>.query`` / ``<data>.position``
side files (reference ``src/io/metadata.cpp``), and the header's feature
names.  Tokens are read
with Python's ``float`` (``na``, ``nan``, ``null``, ``none`` and empty
tokens are NaN).  The JAX package's threaded C++ parser and its two-round
loader are not ported (ROADMAP A1b, A1c).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _sniff_format(lines) -> str:
    """Reference parser.cpp: count separators on sample lines."""
    for line in lines:
        if not line.strip():
            continue
        tokens = line.replace("\t", " ").replace(",", " ").split()
        for tok in tokens[1:3]:
            if ":" in tok:
                return "libsvm"
        if "\t" in line:
            return "tsv"
        if "," in line:
            return "csv"
    return "csv"


def _sniff_sep(line: str) -> str:
    """Separator of one delimited line — tab beats comma beats whitespace
    (reference parser.cpp sniffs TSV before CSV; files with neither parse
    as whitespace-delimited).  ONE shared helper, used by both the data
    parser and the header resolver, so their sniffing can never disagree."""
    if "\t" in line:
        return "\t"
    if "," in line:
        return ","
    return " "


def _split_line(line: str, sep: str):
    """Split one data/header line by the sniffed separator (whitespace runs
    collapse under the space separator, like ``np.loadtxt``)."""
    return line.split() if sep == " " else line.split(sep)


def _parse_libsvm(lines, num_features: Optional[int] = None):
    labels, rows = [], []
    max_f = -1
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        labels.append(float(parts[0]))
        row = {}
        for tok in parts[1:]:
            k, _, v = tok.partition(":")
            fi = int(k)
            row[fi] = float(v)
            max_f = max(max_f, fi)
        rows.append(row)
    nf = num_features or (max_f + 1)
    X = np.zeros((len(rows), nf))
    for i, row in enumerate(rows):
        for k, v in row.items():
            if k < nf:
                X[i, k] = v
    return X, np.asarray(labels)


def load_data_file(
    path: str,
    label_column: str = "",
    header: bool = False,
    num_features: Optional[int] = None,
    weight_column: str = "",
    group_column: str = "",
    ignore_column: str = "",
    with_feature_names: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Returns (X, y, weight, group) — plus the feature-name list (header
    minus label/extracted columns, None without a header) when
    ``with_feature_names`` is set.

    ``weight_column`` / ``group_column`` / ``ignore_column`` follow the
    reference's in-data column specs (docs/Parameters.rst: integer indices
    do NOT count the label column; ``name:<col>`` uses the header; the
    group column carries per-row query ids over grouped data).  Absent
    column specs, weight/group come from ``<path>.weight`` /
    ``<path>.query`` side files (reference metadata.cpp)."""
    header_line = None
    # sniff the format and separator once from the file head; the column
    # specs and ``name:`` resolution below reuse the resolved ``sep``
    first = []
    with open(path) as fh:
        for _ in range(11):
            ln = fh.readline()
            if not ln:
                break
            first.append(ln.rstrip("\n"))
    if header and first:
        header_line = first[0]
    fmt, sep, label_idx = _resolve_format_and_label(
        first, label_column, header)
    if fmt == "libsvm" and (weight_column or group_column or ignore_column):
        # Reference column specs index CSV/TSV columns; LibSVM rows are
        # sparse feature:value pairs where a column index has no meaning.
        raise ValueError(
            "weight_column/group_column/ignore_column cannot be used with "
            "LibSVM input (column indices have no meaning there); use the "
            f"side files {path}.weight / {path}.query instead")
    with open(path) as fh:
        lines = fh.read().splitlines()
    start = 1 if header else 0
    if fmt == "libsvm":
        X, y = _parse_libsvm(lines[start:], num_features)
    else:
        data = np.asarray(
            [[_atof(v) for v in _split_line(line, sep)]
             for line in lines[start:] if line.strip()])
        y = data[:, label_idx]
        X = np.delete(data, label_idx, axis=1)
    X, weight, group, dropped = _apply_column_specs(
        X, path, header, label_column, weight_column, group_column,
        ignore_column, header_line=header_line, sep=sep)
    # side files load independently (reference metadata.cpp); an in-data
    # column wins only for its own field
    sw, sg = _side_files(path)
    out = (X, y, weight if weight is not None else sw,
           group if group is not None else sg)
    if not with_feature_names:
        return out
    names = None
    if header:
        cols, label_idx, _ = _resolve_header(path, label_column,
                                             header_line, sep)
        names = [c for i, c in enumerate(cols) if i != label_idx]
        names = [c for i, c in enumerate(names) if i not in dropped]
        if len(names) != X.shape[1]:
            names = None              # header malformed; fall back to auto
    return out + (names,)


def _resolve_header(path, label_column, header_line=None, sep=None):
    """(names, label_idx, sep) from the header line, read at most once.
    ``sep`` should be the separator already resolved by
    ``_resolve_format_and_label``; when absent it is sniffed with the SAME
    shared helper (``_sniff_sep``), so space-separated files with headers
    resolve ``name:`` column specs the same way the data parser splits
    rows.  Label tolerance matches _resolve_format_and_label: bare
    non-numeric specs fall back to column 0."""
    if header_line is None:
        with open(path) as fh:
            header_line = fh.readline().rstrip("\n")
    if sep is None:
        sep = _sniff_sep(header_line)
    names = [c.strip() for c in _split_line(header_line, sep)]
    lc = str(label_column)
    if lc.startswith("name:") and lc[5:] in names:
        label_idx = names.index(lc[5:])
    else:
        try:
            label_idx = int(lc) if lc else 0
        except ValueError:
            label_idx = 0
    return names, label_idx, sep


def _apply_column_specs(X, path, header, label_column, weight_column,
                        group_column, ignore_column, header_line=None,
                        sep=None):
    """Extract in-data weight/query columns and drop ignored columns
    (reference semantics: integer indices do NOT count the label column;
    ``name:`` specs resolve against the header, read at most once, split
    with the caller's already-resolved separator)."""
    if not (weight_column or group_column or ignore_column):
        return X, None, None, set()
    specs = [str(weight_column), str(group_column), str(ignore_column)]
    names = label_idx = None
    if any(sp.startswith("name:") for sp in specs):
        if not header:
            raise ValueError("name: column specs need header=true")
        names, label_idx, _ = _resolve_header(path, label_column,
                                              header_line, sep)

    def to_idx(spec):
        spec = spec.strip()
        if not spec.startswith("name:"):
            return int(spec)
        fidx = names.index(spec[5:])
        if fidx == label_idx:
            raise ValueError(f"{spec!r} is the label column")
        return fidx - (1 if fidx > label_idx else 0)

    weight = group = None
    drop = []
    if weight_column:
        wi = to_idx(str(weight_column))
        weight = X[:, wi].copy()
        drop.append(wi)
    if group_column:
        gi = to_idx(str(group_column))
        qid = X[:, gi]
        drop.append(gi)
        # per-row query ids over grouped data -> group sizes (reference
        # metadata.cpp query-id run-length conversion)
        if len(qid):
            boundaries = np.flatnonzero(np.diff(qid)) + 1
            bounds = np.concatenate([[0], boundaries, [len(qid)]])
            group = np.diff(bounds).astype(np.int64)
    if ignore_column:
        ic = str(ignore_column)
        if ic.startswith("name:"):
            # name: prefix applies once, then comma-separated names
            # (reference docs/Parameters.rst ignore_column)
            drop.extend(to_idx(f"name:{nm.strip()}")
                        for nm in ic[5:].split(",") if nm.strip())
        else:
            drop.extend(int(tok) for tok in ic.replace(";", ",").split(",")
                        if tok.strip())
    drop = set(drop)
    return np.delete(X, sorted(drop), axis=1), weight, group, drop


def _side_files(path: str):
    weight = group = None
    if os.path.exists(path + ".weight"):
        weight = np.loadtxt(path + ".weight")
    if os.path.exists(path + ".query"):
        group = np.loadtxt(path + ".query").astype(np.int64)
    return weight, group


def position_side_file(path: str, expected_rows: Optional[int] = None):
    """``<data>.position`` (reference Advanced-Topics.rst:108,
    metadata.cpp): one position per row; any identifiers factorize to
    dense int32 ids, as the reference maps its position strings."""
    if not os.path.exists(path + ".position"):
        return None
    raw = np.loadtxt(path + ".position", dtype=str, ndmin=1)
    if expected_rows is not None and len(raw) != expected_rows:
        raise ValueError(
            f"{path}.position has {len(raw)} rows; data has "
            f"{expected_rows}")
    _, ids = np.unique(raw, return_inverse=True)
    return ids.astype(np.int32)


def _atof(tok: str) -> float:
    tok = tok.strip()
    if tok == "" or tok.lower() in ("na", "nan", "null", "none"):
        return np.nan
    return float(tok)


def _resolve_format_and_label(first_lines, label_column: str,
                              header: bool):
    """Shared sniff + label-column resolution for the one-shot and
    two-round loaders (keeps their semantics identical by construction).
    The separator comes from ``_sniff_sep`` on the first data line, so
    space-separated files resolve consistently everywhere."""
    start = 1 if header else 0
    fmt = _sniff_format(first_lines[start: start + 10])
    sep = ","
    for ln in first_lines[start:]:
        if ln.strip():
            sep = _sniff_sep(ln)
            break
    label_idx = 0
    if label_column.startswith("name:") and header:
        label_idx = _split_line(first_lines[0], sep).index(label_column[5:])
    elif label_column:
        try:
            label_idx = int(label_column)
        except ValueError:
            label_idx = 0
    return fmt, sep, label_idx
