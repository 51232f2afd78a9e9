"""sqllogictest-style test runner.

The analog of the reference's SQL logic test harness (reference
test/sqlite/sqllogic_test_runner.cpp, sqllogic_parser.cpp,
sqllogic_command.cpp), which executes the bulk of its test suite: 2904
`.test` files of `statement ok/error` and `query` directives diffed against
inline expected output.  This runner executes the same file format against
the TPU engine's Connection API.

Supported directives (the subset the reference tests actually use):

    # comment
    statement ok
    <sql...>                         (multi-line, until blank line)

    statement error
    <sql...>
    ----                             (optional expected-message substring)
    <substring>

    query <types> [nosort|rowsort|valuesort] [label]
    <sql...>
    ----
    <expected rows, tab-separated>   (until blank line; or `<FILE>:path`)

    require <feature>                (skips rest of file if unavailable)
    mode skip / mode unskip
    loop <var> <start> <end>         (end exclusive, like the reference)
    ...  ${var} substitution ...
    endloop
    load <path>                      (attach/open a durable database dir)
    restart                          (reopen the attached database: WAL
                                      replay exercise, reference
                                      sqllogic_test_runner.cpp RestartCommand)
    skipif <system> / onlyif <system>  (this engine answers as "duckdb")
    hashed results: "N values hashing to <md5>" compare supported

Types: I = integer, R = float (compared at 3 decimals, like sqllogictest),
T = text.  NULL renders as the literal `NULL`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


class SqlLogicError(AssertionError):
    pass


@dataclass
class _Record:
    kind: str                     # "statement_ok" | "statement_error" | "query"
    sql: str
    line: int
    types: str = ""
    sort: str = "nosort"
    label: str = ""
    expected: list[str] = field(default_factory=list)
    expected_file: str = ""
    error_substring: str = ""


@dataclass
class Report:
    path: str
    executed: int = 0
    skipped: bool = False
    labels: dict = field(default_factory=dict)


def _parse_blocks(lines: list[str]):
    """Expand loop/endloop, then yield directive blocks as
    (first_line_no, [lines])."""
    expanded: list[tuple[int, str]] = []

    def expand(i: int, stop: str | None, bindings: dict) -> int:
        while i < len(lines):
            raw = lines[i].rstrip("\n")
            stripped = raw.strip()
            if stop is not None and stripped == stop:
                return i
            m = re.match(r"loop\s+(\w+)\s+(-?\d+)\s+(-?\d+)\s*$", stripped)
            if m:
                var, lo, hi = m.group(1), int(m.group(2)), int(m.group(3))
                body_start = i + 1
                # find matching endloop (no nesting of same var needed; support
                # nested loops via recursion with a depth counter)
                depth, j = 1, body_start
                while j < len(lines):
                    s = lines[j].strip()
                    if s.startswith("loop "):
                        depth += 1
                    elif s == "endloop":
                        depth -= 1
                        if depth == 0:
                            break
                    j += 1
                if depth != 0:
                    raise SqlLogicError(f"line {i+1}: loop without endloop")
                for v in range(lo, hi):
                    b = dict(bindings)
                    b[var] = v
                    expand_range(body_start, j, b)
                i = j + 1
                continue
            text = raw
            for k, v in bindings.items():
                text = text.replace("${" + k + "}", str(v))
            expanded.append((i + 1, text))
            i += 1
        return i

    def expand_range(start: int, stop_idx: int, bindings: dict):
        i = start
        while i < stop_idx:
            raw = lines[i].rstrip("\n")
            stripped = raw.strip()
            m = re.match(r"loop\s+(\w+)\s+(-?\d+)\s+(-?\d+)\s*$", stripped)
            if m:
                var, lo, hi = m.group(1), int(m.group(2)), int(m.group(3))
                depth, j = 1, i + 1
                while j < stop_idx:
                    s = lines[j].strip()
                    if s.startswith("loop "):
                        depth += 1
                    elif s == "endloop":
                        depth -= 1
                        if depth == 0:
                            break
                    j += 1
                for v in range(lo, hi):
                    b = dict(bindings)
                    b[var] = v
                    expand_range(i + 1, j, b)
                i = j + 1
                continue
            text = raw
            for k, v in bindings.items():
                text = text.replace("${" + k + "}", str(v))
            expanded.append((i + 1, text))
            i += 1

    expand(0, None, {})

    # group into blocks separated by blank lines
    block: list[tuple[int, str]] = []
    for ln, text in expanded + [(0, "")]:
        if text.strip() == "" and block:
            yield block
            block = []
        elif text.strip() != "":
            block.append((ln, text))


def _parse_record(block: list[tuple[int, str]]):
    """-> _Record | ('require', feature) | ('mode', word) | None."""
    # drop leading comments
    while block and block[0][1].lstrip().startswith("#"):
        block = block[1:]
    if not block:
        return None
    line0, head = block[0]
    words = head.split()
    # record-level conditions: skipif/onlyif prefix lines
    skip_record = False
    while words and words[0] in ("skipif", "onlyif"):
        system = words[1].lower() if len(words) > 1 else ""
        is_us = system in ("duckdb", "duckdb_cubit_tpu")
        if (words[0] == "skipif" and is_us) or \
                (words[0] == "onlyif" and not is_us):
            skip_record = True
        block = block[1:]
        if not block:
            return None
        line0, head = block[0]
        words = head.split()
    if skip_record:
        return None
    if words[0] in ("load", "restart"):
        return (words[0], words[1] if len(words) > 1 else "")
    if words[0] == "require":
        return ("require", words[1] if len(words) > 1 else "")
    if words[0] == "mode":
        return ("mode", words[1] if len(words) > 1 else "")
    if words[0] == "hash-threshold":
        return None
    body = [t for _, t in block[1:]]
    if words[0] == "statement":
        if len(words) < 2 or words[1] not in ("ok", "error"):
            raise SqlLogicError(f"line {line0}: bad statement directive")
        sql_lines, rest = _split_at_separator(body)
        rec = _Record(kind="statement_" + words[1],
                      sql="\n".join(sql_lines), line=line0)
        if rest:
            rec.error_substring = "\n".join(rest).strip()
        return rec
    if words[0] == "query":
        types = words[1] if len(words) > 1 else ""
        sort = "nosort"
        label = ""
        for w in words[2:]:
            if w in ("nosort", "rowsort", "valuesort"):
                sort = w
            else:
                label = w
        sql_lines, rest = _split_at_separator(body)
        rec = _Record(kind="query", sql="\n".join(sql_lines), line=line0,
                      types=types, sort=sort, label=label)
        if len(rest) == 1 and rest[0].startswith("<FILE>:"):
            rec.expected_file = rest[0][len("<FILE>:"):].strip()
        else:
            rec.expected = rest
        return rec
    raise SqlLogicError(f"line {line0}: unknown directive {words[0]!r}")


def _split_at_separator(body: list[str]):
    for i, t in enumerate(body):
        if t.strip() == "----":
            return body[:i], body[i + 1:]
    return body, []


def _fmt(value, ty: str) -> str:
    if value is None:
        return "NULL"
    if ty == "R":
        return f"{float(value):.3f}"
    if ty == "I":
        if isinstance(value, bool):
            return "1" if value else "0"
        try:
            return str(int(value))
        except (TypeError, ValueError):
            return str(value)
    s = value if isinstance(value, str) else str(value)
    if isinstance(value, bool):
        s = "true" if value else "false"
    return s if s != "" else "(empty)"


def _norm_expected_cell(cell: str, ty: str) -> str:
    cell = cell.strip()
    if cell == "NULL":
        return "NULL"
    if ty == "R":
        try:
            return f"{float(cell):.3f}"
        except ValueError:
            return cell
    return cell if cell != "" else "(empty)"


def _result_to_cells(result, types: str) -> list[list[str]]:
    # Use typed python values where available; fall back to strings.
    rel = result.relation
    if rel is None:
        rows = result.rows()
        return [[_fmt(v, types[j] if j < len(types) else "T")
                 for j, v in enumerate(r)] for r in rows]
    from ..exec import result as R

    strs = R.to_strings(rel)
    _, rows, metas = R.materialize(rel)
    out = []
    for srow, vrow in zip(strs, rows):
        cells = []
        for j, (s, v) in enumerate(zip(srow, vrow)):
            ty = types[j] if j < len(types) else "T"
            if ty == "R":
                cells.append(f"{float(s):.3f}" if _is_num(s) else s)
            else:
                cells.append(s if s != "" else "(empty)")
        out.append(cells)
    return out


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _split_expected_row(line: str, ncols: int) -> list[str]:
    if "\t" in line:
        return line.split("\t")
    parts = line.split()
    if len(parts) == ncols:
        return parts
    # allow multi-space separation of text values containing single spaces
    return re.split(r"\s{2,}|\t", line.strip())


def run_script(text: str, conn=None, path: str = "<script>",
               features: set[str] | None = None) -> Report:
    if conn is None:
        from ..api import Connection

        conn = Connection()
    # corpus files toggle PRAGMA enable_verification pervasively; run the
    # light leg set (eager + unoptimized + row-by-row python) so a file of
    # dozens of tiny queries doesn't pay a jit compile per query
    if getattr(conn, "config", None) is not None:
        conn.config.verification_legs = "light"
    features = features if features is not None else _default_features()
    report = Report(path=path)
    skipping = False
    # the reference corpus parameterizes persistent-db paths with
    # __TEST_DIR__; give each script run a fresh temp dir so files are
    # hermetic (reference sqllogic_test_runner.cpp TestDirectoryPath)
    if "__TEST_DIR__" in text:
        import tempfile

        tdir = tempfile.mkdtemp(prefix="sqllogic_")
        text = text.replace("__TEST_DIR__", tdir)
    lines = text.splitlines()
    for block in _parse_blocks(lines):
        rec = _parse_record(block)
        if rec is None:
            continue
        if isinstance(rec, tuple):
            kind, arg = rec
            if kind == "mode":
                skipping = (arg == "skip")
            elif kind == "load":
                from ..storage.persist import open_database
                if os.path.isdir(arg) and os.path.exists(
                        os.path.join(arg, "manifest.json")):
                    conn = open_database(arg)
                else:
                    conn = conn.attach(arg)
            elif kind == "restart":
                # reopen the attached database: checkpoint+WAL replay path
                from ..storage.persist import open_database
                if getattr(conn, "db_path", None):
                    conn = open_database(conn.db_path)
            elif kind == "require":
                if arg == "tpch":
                    _ensure_tpch(conn)
                    continue
                if arg not in features:
                    report.skipped = True
                    return report
            continue
        if skipping:
            continue
        _run_record(conn, rec, report, path)
    return report


def _default_features() -> set[str]:
    feats = {"sqllogic"}
    from ..tpch import answers

    if answers.answers_available():
        feats.add("tpch_answers")
    return feats


def _ensure_tpch(conn):
    if "lineitem" not in getattr(conn.catalog, "tables", {}):
        conn.load_tpch(0.01)


def _run_record(conn, rec: _Record, report: Report, path: str):
    where = f"{path}:{rec.line}"
    if rec.kind == "statement_ok":
        try:
            conn.sql(rec.sql)
        except Exception as e:  # noqa: BLE001
            raise SqlLogicError(
                f"{where}: statement ok failed:\n{rec.sql}\n--> {e}") from e
        report.executed += 1
        return
    if rec.kind == "statement_error":
        try:
            conn.sql(rec.sql)
        except Exception as e:  # noqa: BLE001
            if rec.error_substring and rec.error_substring not in str(e):
                raise SqlLogicError(
                    f"{where}: error message mismatch:\n expected substring: "
                    f"{rec.error_substring!r}\n got: {e}") from e
            report.executed += 1
            return
        raise SqlLogicError(
            f"{where}: statement was expected to fail but succeeded:\n"
            f"{rec.sql}")
    # query
    try:
        result = conn.sql(rec.sql)
    except Exception as e:  # noqa: BLE001
        raise SqlLogicError(
            f"{where}: query raised:\n{rec.sql}\n--> {e}") from e
    got = _result_to_cells(result, rec.types)
    if rec.types and got and len(got[0]) != len(rec.types):
        raise SqlLogicError(
            f"{where}: expected {len(rec.types)} columns, got {len(got[0])}")
    if rec.expected_file:
        sep = "|" if rec.expected_file.endswith(".csv") else "\t"
        with open(rec.expected_file) as f:
            raw = f.read().splitlines()
        if rec.expected_file.endswith(".csv") and raw:
            raw = raw[1:]  # header
        expected_rows = [
            [_norm_expected_cell(c, rec.types[j] if j < len(rec.types) else "T")
             for j, c in enumerate(r.split(sep))]
            for r in raw if r.strip() != ""]
    else:
        raw_rows = [_split_expected_row(r, len(rec.types))
                    for r in rec.expected]
        ncols = max(1, len(rec.types))
        if (ncols > 1 and raw_rows and all(len(r) == 1 for r in raw_rows)
                and len(raw_rows) % ncols == 0
                and not any("\t" in r for r in rec.expected)):
            # canonical sqllogictest layout: ONE VALUE PER LINE in
            # row-major order (the reference's own runner accepts both)
            flat = [r[0] for r in raw_rows]
            raw_rows = [flat[i:i + ncols]
                        for i in range(0, len(flat), ncols)]
        expected_rows = [
            [_norm_expected_cell(c, rec.types[j] if j < len(rec.types) else "T")
             for j, c in enumerate(r)] for r in raw_rows]
    if rec.label:
        prev = report.labels.get(rec.label)
        if prev is not None and prev != got:
            raise SqlLogicError(
                f"{where}: result differs from earlier query "
                f"labeled {rec.label!r}")
        report.labels[rec.label] = got
        if not rec.expected and not rec.expected_file:
            report.executed += 1
            return
    # sqllogictest hashed form: "N values hashing to <md5>"
    if len(rec.expected) == 1 and not rec.expected_file:
        m = re.match(r"(\d+) values hashing to ([0-9a-f]{32})",
                     rec.expected[0].strip())
        if m:
            import hashlib
            vals = [v for r in got for v in r]
            if rec.sort == "rowsort":
                vals = [v for r in sorted(got) for v in r]
            elif rec.sort == "valuesort":
                vals = sorted(vals)
            digest = hashlib.md5(
                ("".join(v + "\n" for v in vals)).encode()).hexdigest()
            if len(vals) != int(m.group(1)) or digest != m.group(2):
                raise SqlLogicError(
                    f"{where}: hash mismatch ({len(vals)} values, "
                    f"{digest})")
            report.executed += 1
            return
    if rec.sort == "rowsort":
        got = sorted(got)
        expected_rows = sorted(expected_rows)
    elif rec.sort == "valuesort":
        got = sorted(v for r in got for v in r)
        expected_rows = sorted(v for r in expected_rows for v in r)
        if got != expected_rows:
            raise SqlLogicError(_diff_msg(where, rec, expected_rows, got))
        report.executed += 1
        return
    if got != expected_rows:
        raise SqlLogicError(_diff_msg(where, rec, expected_rows, got))
    report.executed += 1


def _diff_msg(where, rec, expected, got):
    def show(rows):
        if rows and isinstance(rows[0], list):
            return "\n".join("\t".join(r) for r in rows[:12])
        return "\n".join(str(r) for r in rows[:12])

    return (f"{where}: result mismatch for\n{rec.sql}\n"
            f"-- expected ({len(expected)} rows) --\n{show(expected)}\n"
            f"-- got ({len(got)} rows) --\n{show(got)}")


def run_file(path: str, conn=None) -> Report:
    with open(path) as f:
        text = f.read()
    return run_script(text, conn=conn, path=os.path.basename(path))
