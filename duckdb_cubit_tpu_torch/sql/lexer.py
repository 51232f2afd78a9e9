"""SQL tokenizer.

Analog of the reference's scanner inside the vendored PostgreSQL grammar
(reference third_party/libpg_query); a compact hand-rolled lexer is the
right size for the engine's SQL subset.
"""

from __future__ import annotations

import dataclasses

KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "having",
    "as", "and", "or", "not", "in", "like", "between", "is", "null",
    "case", "when", "then", "else", "end", "cast", "date", "interval",
    "exists", "distinct", "asc", "desc", "join", "inner", "left", "right",
    "full", "asof", "outer", "on", "union", "all", "substring", "extract",
    "year", "month",
    "day", "for", "count", "sum", "avg", "min", "max", "true", "false",
}


@dataclasses.dataclass
class Token:
    kind: str  # kw | ident | number | string | op
    value: str
    pos: int


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            while j < n and (sql[j].isdigit() or sql[j] == "."):
                j += 1
            out.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            kind = "kw" if word.lower() in KEYWORDS else "ident"
            out.append(Token(kind, word.lower() if kind == "kw" else word, i))
            i = j
            continue
        for op in ("<>", "<=", ">=", "!=", "||", "::"):
            if sql.startswith(op, i):
                out.append(Token("op", op, i))
                i += 2
                break
        else:
            if c in "+-*/()<>=,.;%":
                out.append(Token("op", c, i))
                i += 1
            else:
                raise LexError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", n))
    return out
