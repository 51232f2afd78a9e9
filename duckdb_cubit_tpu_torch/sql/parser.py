"""Recursive-descent SQL parser for the engine's SQL subset.

Analog of the reference's parser layer (reference src/parser/ +
third_party/libpg_query, Postgres grammar): covers the SELECT grammar the
TPC-H workload exercises — expressions with precedence, CASE, CAST,
EXTRACT, SUBSTRING, date/interval literals, [NOT] IN/LIKE/BETWEEN/EXISTS,
scalar subqueries, comma and explicit JOIN table lists, GROUP BY/HAVING/
ORDER BY/LIMIT.
"""

from __future__ import annotations

from . import ast as A
from .lexer import Token, tokenize


class ParseError(ValueError):
    pass


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # ------------------------------------------------------------ plumbing
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: str | None = None) -> Token | None:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: str | None = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise ParseError(f"expected {value or kind}, got {got.kind} "
                             f"{got.value!r} at {got.pos}")
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in words

    # ------------------------------------------------------------- entry
    def parse(self) -> A.SelectStmt:
        stmt = self.parse_select()
        self.accept("op", ";")
        self.expect("eof")
        return stmt

    def parse_statement(self):
        """Any statement: SELECT plus the DDL/DML grammar (statement nodes
        mirror the reference's src/parser/statement/ set)."""
        t = self.peek()
        w = t.value.lower() if t.kind in ("kw", "ident") else ""
        if w in ("select", "with"):
            return self.parse()
        dispatch = {
            "create": self.parse_create,
            "insert": self.parse_insert,
            "delete": self.parse_delete,
            "update": self.parse_update,
            "drop": self.parse_drop,
            "set": self.parse_set,
            "begin": self.parse_transaction,
            "commit": self.parse_transaction,
            "rollback": self.parse_transaction,
            "abort": self.parse_transaction,
            "explain": self.parse_explain,
            "pragma": self.parse_pragma,
        }
        if w not in dispatch:
            raise ParseError(f"unsupported statement start {t.value!r}")
        stmt = dispatch[w]()
        self.accept("op", ";")
        self.expect("eof")
        return stmt

    # ------------------------------------------------------ DDL/DML grammar
    def _word(self, *expected: str) -> str:
        t = self.next()
        w = t.value.lower()
        if t.kind not in ("kw", "ident") or (expected and w not in expected):
            raise ParseError(f"expected {'/'.join(expected)}, got {t.value!r}")
        return w

    def _at_word(self, *words: str) -> bool:
        t = self.peek()
        return t.kind in ("kw", "ident") and t.value.lower() in words

    def _ident(self) -> str:
        t = self.next()
        if t.kind not in ("ident", "kw"):
            raise ParseError(f"expected identifier, got {t.value!r}")
        return t.value

    def parse_create(self):
        self._word("create")
        kind = self._word("table", "index", "unique", "cubit")
        if kind == "cubit":
            self._word("index")
            kind = "index"
            using_default = "cubit"
        elif kind == "unique":
            self._word("index")
            kind = "index"
            using_default = "pk"
        else:
            using_default = "cubit"
        if kind == "table":
            name = self._ident()
            if self._at_word("as"):
                self.next()
                select = self.parse_select()
                return A.CreateTableAs(name, select)
            self.expect("op", "(")
            cols = [self.parse_column_def()]
            while self.accept("op", ","):
                cols.append(self.parse_column_def())
            self.expect("op", ")")
            return A.CreateTable(name, cols)
        # CREATE [CUBIT|UNIQUE] INDEX [name] ON table (col) [WITH (bins=N)]
        idx_name = None
        if not self._at_word("on"):
            idx_name = self._ident()
        self._word("on")
        table = self._ident()
        self.expect("op", "(")
        column = self._ident()
        self.expect("op", ")")
        using = using_default
        n_bins = None
        if self._at_word("using"):
            self.next()
            using = self._word("cubit", "pk", "bitmap")
            if using == "bitmap":
                using = "cubit"
        if self._at_word("with"):
            self.next()
            self.expect("op", "(")
            self._word("bins")
            self.expect("op", "=")
            n_bins = int(self.expect("number").value)
            self.expect("op", ")")
        return A.CreateIndex(idx_name, table, column, using, n_bins)

    def parse_column_def(self) -> A.ColumnDef:
        name = self._ident()
        t = self.next()
        if t.kind not in ("ident", "kw"):
            raise ParseError(f"expected type, got {t.value!r}")
        type_name = t.value.lower()
        params = []
        if self.accept("op", "("):
            params.append(int(self.expect("number").value))
            while self.accept("op", ","):
                params.append(int(self.expect("number").value))
            self.expect("op", ")")
        # consume ignored column attributes (PRIMARY KEY, NOT NULL)
        while self._at_word("primary", "not", "key", "null", "unique"):
            self.next()
        return A.ColumnDef(name, type_name, params)

    def parse_insert(self):
        self._word("insert")
        self._word("into")
        table = self._ident()
        columns = None
        if self.peek().kind == "op" and self.peek().value == "(":
            self.next()
            columns = [self._ident()]
            while self.accept("op", ","):
                columns.append(self._ident())
            self.expect("op", ")")
        if self._at_word("values"):
            self.next()
            rows = [self.parse_value_row()]
            while self.accept("op", ","):
                rows.append(self.parse_value_row())
            return A.Insert(table, columns, rows)
        select = self.parse_select()
        return A.Insert(table, columns, [], select)

    def parse_value_row(self) -> list:
        self.expect("op", "(")
        row = [self.parse_expr()]
        while self.accept("op", ","):
            row.append(self.parse_expr())
        self.expect("op", ")")
        return row

    def parse_delete(self):
        self._word("delete")
        self._word("from")
        table = self._ident()
        where = self.parse_expr() if self.accept("kw", "where") else None
        return A.Delete(table, where)

    def parse_update(self):
        self._word("update")
        table = self._ident()
        self._word("set")
        assignments = []
        while True:
            col = self._ident()
            self.expect("op", "=")
            assignments.append((col, self.parse_expr()))
            if not self.accept("op", ","):
                break
        where = self.parse_expr() if self.accept("kw", "where") else None
        return A.Update(table, assignments, where)

    def parse_drop(self):
        self._word("drop")
        self._word("table")
        if_exists = False
        if self._at_word("if"):
            self.next()
            self._word("exists")
            if_exists = True
        return A.DropTable(self._ident(), if_exists)

    def parse_set(self):
        self._word("set")
        name = self._ident()
        if not self.accept("op", "="):
            self._word("to")
        t = self.next()
        if t.kind == "number":
            value = float(t.value) if "." in t.value else int(t.value)
        elif t.kind == "string":
            value = t.value
        elif t.kind in ("ident", "kw"):
            value = {"true": True, "false": False, "on": True,
                     "off": False}.get(t.value.lower(), t.value)
        else:
            raise ParseError(f"bad SET value {t.value!r}")
        return A.SetStmt(name, value)

    def parse_transaction(self):
        w = self._word("begin", "commit", "rollback", "abort")
        if w == "begin" and self._at_word("transaction"):
            self.next()
        return A.TransactionStmt("rollback" if w == "abort" else w)

    def parse_explain(self):
        self._word("explain")
        analyze = False
        if self._at_word("analyze"):
            self.next()
            analyze = True
        return A.ExplainStmt(self.parse_select(), analyze)

    def parse_pragma(self):
        self._word("pragma")
        name = self._ident()
        args = []
        if self.accept("op", "("):
            while not self.accept("op", ")"):
                t = self.next()
                if t.kind == "number":
                    args.append(float(t.value) if "." in t.value
                                else int(t.value))
                else:
                    args.append(t.value)
                self.accept("op", ",")
        return A.PragmaStmt(name, args)

    def parse_select(self) -> A.SelectStmt:
        ctes = None
        if self._at_word("with"):
            self.next()
            ctes = []
            while True:
                name = self._ident()
                cols = None
                if self.accept("op", "("):
                    cols = [self._ident()]
                    while self.accept("op", ","):
                        cols.append(self._ident())
                    self.expect("op", ")")
                self._word("as")
                self.expect("op", "(")
                sub = self.parse_select()
                self.expect("op", ")")
                ctes.append((name, cols, sub))
                if not self.accept("op", ","):
                    break
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        items = [self.parse_select_item()]
        while self.accept("op", ","):
            items.append(self.parse_select_item())
        tables: list[A.TableRef] = []
        where = None
        group_by: list = []
        having = None
        order_by: list[A.OrderItem] = []
        limit = None
        if self.accept("kw", "from"):
            tables.append(self.parse_table_ref())
            while True:
                if self.accept("op", ","):
                    tables.append(self.parse_table_ref())
                    continue
                joined = self.parse_join_suffix(tables)
                if joined:
                    continue
                break
        if self.accept("kw", "where"):
            where = self.parse_expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self.parse_expr())
            while self.accept("op", ","):
                group_by.append(self.parse_expr())
        if self.accept("kw", "having"):
            having = self.parse_expr()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            order_by.append(self.parse_order_item())
            while self.accept("op", ","):
                order_by.append(self.parse_order_item())
        if self.accept("kw", "limit"):
            limit = int(self.expect("number").value)
        return A.SelectStmt(items, tables, where, group_by, having,
                            order_by, limit, distinct, ctes=ctes)

    def parse_join_suffix(self, tables: list) -> bool:
        """INNER/LEFT/RIGHT/FULL/ASOF JOIN t ON cond — the ON condition
        folds into WHERE (join-type recorded on the TableRef for the
        binder)."""
        join_type = None
        if self.at_kw("join", "inner"):
            self.accept("kw", "inner")
            self.expect("kw", "join")
            join_type = "inner"
        elif self.at_kw("left"):
            self.next()
            self.accept("kw", "outer")
            self.expect("kw", "join")
            join_type = "left"
        elif self.at_kw("right"):
            self.next()
            self.accept("kw", "outer")
            self.expect("kw", "join")
            join_type = "right"
        elif self.at_kw("full"):
            self.next()
            self.accept("kw", "outer")
            self.expect("kw", "join")
            join_type = "full"
        elif self.at_kw("asof"):
            self.next()
            join_type = "asof_left" if self.accept("kw", "left") else "asof"
            self.accept("kw", "outer")
            self.expect("kw", "join")
        else:
            return False
        ref = self.parse_table_ref()
        ref.join_type = join_type  # type: ignore[attr-defined]
        self.expect("kw", "on")
        cond = self.parse_expr()
        ref.join_cond = cond  # type: ignore[attr-defined]
        tables.append(ref)
        return True

    def parse_table_ref(self) -> A.TableRef:
        if self.accept("op", "("):
            sub = self.parse_select()
            self.expect("op", ")")
            self.accept("kw", "as")
            alias_t = self.accept("ident")
            col_aliases = None
            if self.accept("op", "("):
                col_aliases = [self.expect("ident").value]
                while self.accept("op", ","):
                    col_aliases.append(self.expect("ident").value)
                self.expect("op", ")")
            return A.TableRef(name="", alias=alias_t.value if alias_t else None,
                              subquery=sub, column_aliases=col_aliases)
        name = self.expect("ident").value
        func_args = None
        if self.accept("op", "("):       # table function: range(1, 10)
            func_args = []
            if not self.accept("op", ")"):
                func_args.append(self.parse_expr())
                while self.accept("op", ","):
                    func_args.append(self.parse_expr())
                self.expect("op", ")")
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        col_aliases = None
        if alias is not None and self.accept("op", "("):
            col_aliases = [self.expect("ident").value]
            while self.accept("op", ","):
                col_aliases.append(self.expect("ident").value)
            self.expect("op", ")")
        return A.TableRef(name=name, alias=alias,
                          column_aliases=col_aliases, func_args=func_args)

    def parse_select_item(self) -> A.SelectItem:
        if self.peek().kind == "op" and self.peek().value == "*":
            self.next()
            return A.SelectItem(A.ColumnRef(None, "*"), None)
        expr = self.parse_expr()
        alias = None
        if self.accept("kw", "as"):
            alias = (self.accept("ident") or self.expect("kw")).value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return A.SelectItem(expr, alias)

    def parse_order_item(self) -> A.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept("kw", "desc"):
            desc = True
        else:
            self.accept("kw", "asc")
        return A.OrderItem(e, desc)

    # ---------------------------------------------------------- expressions
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.accept("kw", "or"):
            left = A.BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept("kw", "and"):
            left = A.BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept("kw", "not"):
            return A.UnaryOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self):
        if self.at_kw("exists"):
            self.next()
            self.expect("op", "(")
            q = self.parse_select()
            self.expect("op", ")")
            return A.ExistsExpr(q)
        left = self.parse_additive()
        negated = bool(self.accept("kw", "not"))
        if self.accept("kw", "between"):
            low = self.parse_additive()
            self.expect("kw", "and")
            high = self.parse_additive()
            return A.BetweenExpr(left, low, high, negated)
        if self.accept("kw", "in"):
            self.expect("op", "(")
            if self.at_kw("select"):
                sub = self.parse_select()
                self.expect("op", ")")
                return A.InExpr(left, sub, negated)
            values = [self.parse_additive()]
            while self.accept("op", ","):
                values.append(self.parse_additive())
            self.expect("op", ")")
            return A.InExpr(left, values, negated)
        if self.accept("kw", "like"):
            pat = self.expect("string").value
            return A.LikeExpr(left, pat, negated)
        if negated:
            raise ParseError("dangling NOT before comparison")
        if self.accept("kw", "is"):
            neg = bool(self.accept("kw", "not"))
            self.expect("kw", "null")
            return A.IsNullExpr(left, neg)
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "==", "<>": "!=", "!=": "!="}.get(t.value, t.value)
            right = self.parse_additive()
            return A.BinaryOp(op, left, right)
        return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                left = A.BinaryOp(t.value, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self):
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = A.BinaryOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self):
        if self.accept("op", "-"):
            return A.UnaryOp("-", self.parse_unary())
        self.accept("op", "+")
        e = self.parse_primary()
        # postfix :: casts (expr::TYPE, duckdb/postgres shorthand)
        while self.accept("op", "::"):
            t = self.next()
            if t.kind not in ("ident", "kw"):
                raise ParseError(f"expected type after :: at {t.pos}")
            if self.accept("op", "("):      # DECIMAL(18, 3) style params
                while not self.accept("op", ")"):
                    self.next()
            e = A.CastExpr(e, t.value.lower())
        return e

    def parse_primary(self):
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.at_kw("select"):
                q = self.parse_select()
                self.expect("op", ")")
                return A.SubqueryExpr(q)
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "number":
            self.next()
            v = t.value
            return A.Literal(float(v) if "." in v else int(v),
                             "decimal" if "." in v else None)
        if t.kind == "string":
            self.next()
            return A.Literal(t.value, "string")
        if self.at_kw("true"):
            self.next()
            return A.Literal(True)
        if self.at_kw("false"):
            self.next()
            return A.Literal(False)
        if self.at_kw("null"):
            self.next()
            return A.Literal(None, "null")
        if self.at_kw("date"):
            self.next()
            s = self.expect("string").value
            return A.Literal(s, "date")
        if self.at_kw("interval"):
            self.next()
            v = int(self.expect("string").value)
            unit = self.next().value  # day/month/year keyword
            return A.IntervalLit(v, unit.rstrip("s"))
        if self.at_kw("case"):
            return self.parse_case()
        if self.at_kw("cast"):
            self.next()
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("kw", "as")
            target = self.next().value
            # swallow type parameters e.g. decimal(12,2)
            if self.accept("op", "("):
                while not self.accept("op", ")"):
                    self.next()
            self.expect("op", ")")
            return A.CastExpr(e, target)
        if self.at_kw("extract"):
            self.next()
            self.expect("op", "(")
            field = self.next().value
            self.expect("kw", "from")
            e = self.parse_expr()
            self.expect("op", ")")
            return A.ExtractExpr(field, e)
        if self.at_kw("substring"):
            self.next()
            self.expect("op", "(")
            e = self.parse_expr()
            if self.accept("kw", "from"):
                start = self.parse_expr()
                self.expect("kw", "for")
                length = self.parse_expr()
            else:
                self.expect("op", ",")
                start = self.parse_expr()
                self.expect("op", ",")
                length = self.parse_expr()
            self.expect("op", ")")
            return A.SubstringExpr(e, start, length)
        if self.at_kw("count", "sum", "avg", "min", "max"):
            fname = self.next().value
            self.expect("op", "(")
            distinct = bool(self.accept("kw", "distinct"))
            if self.peek().kind == "op" and self.peek().value == "*":
                self.next()
                self.expect("op", ")")
                w = self.maybe_over(fname, [], star=True)
                return w if w is not None else A.FuncCall(fname, [], star=True)
            arg = self.parse_expr()
            self.expect("op", ")")
            if not distinct:
                w = self.maybe_over(fname, [arg])
                if w is not None:
                    return w
            return A.FuncCall(fname, [arg], distinct=distinct)
        if t.kind == "ident":
            self.next()
            if self.accept("op", "."):
                col = self.expect("ident").value
                return A.ColumnRef(t.value, col)
            if self.peek().kind == "op" and self.peek().value == "(":
                # generic function call
                self.next()
                args = []
                if not (self.peek().kind == "op" and self.peek().value == ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                w = self.maybe_over(t.value.lower(), args)
                if w is not None:
                    return w
                return A.FuncCall(t.value.lower(), args)
            return A.ColumnRef(None, t.value)
        raise ParseError(f"unexpected token {t.kind} {t.value!r} at {t.pos}")

    def maybe_over(self, fname: str, args: list,
                   star: bool = False) -> A.WindowExpr | None:
        """`OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE BETWEEN ...])`
        window suffix after a function call (reference window binding,
        physical_window.cpp:822)."""
        if not self._at_word("over"):
            return None
        self.next()
        self.expect("op", "(")
        partition_by: list = []
        order_by: list[A.OrderItem] = []
        frame = None
        if self._at_word("partition"):
            self.next()
            self.expect("kw", "by")
            partition_by.append(self.parse_expr())
            while self.accept("op", ","):
                partition_by.append(self.parse_expr())
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            order_by.append(self.parse_order_item())
            while self.accept("op", ","):
                order_by.append(self.parse_order_item())
        if self._at_word("rows", "range"):
            mode = self._word("rows", "range")
            self.expect("kw", "between")
            lo = self._parse_frame_bound(preceding=True)
            self.expect("kw", "and")
            hi = self._parse_frame_bound(preceding=False)
            # degenerate tuples normalize to the legacy fast-path frames
            if lo is None and hi == 0:
                frame = "rows_upto" if mode == "rows" else "range_upto"
            elif lo is None and hi is None:
                frame = "partition"
            else:
                frame = (mode, lo, hi)
        self.expect("op", ")")
        return A.WindowExpr(fname, args, partition_by, order_by, frame,
                            star=star)

    def _parse_frame_bound(self, preceding: bool):
        """One frame bound -> signed int offset (negative = preceding) or
        None for UNBOUNDED.  Grammar: UNBOUNDED PRECEDING|FOLLOWING |
        CURRENT ROW | <int> PRECEDING|FOLLOWING."""
        if self._at_word("unbounded"):
            self.next()
            self._word("preceding" if preceding else "following")
            return None
        if self._at_word("current"):
            self.next()
            self._word("row")
            return 0
        tok = self.peek()
        if tok.kind != "number":
            raise ParseError(f"expected frame bound at {tok.pos}")
        self.next()
        n = int(tok.value)
        direction = self._word("preceding", "following")
        return -n if direction == "preceding" else n

    def parse_case(self):
        self.expect("kw", "case")
        whens = []
        while self.accept("kw", "when"):
            cond = self.parse_expr()
            self.expect("kw", "then")
            res = self.parse_expr()
            whens.append((cond, res))
        default = None
        if self.accept("kw", "else"):
            default = self.parse_expr()
        self.expect("kw", "end")
        return A.CaseExpr(whens, default)


def parse_statement(sql: str):
    """Parse any statement (SELECT or DDL/DML)."""
    return Parser(sql).parse_statement()


def parse(sql: str) -> A.SelectStmt:
    return Parser(sql).parse()
