"""SQL abstract syntax tree (parse targets).

Analog of the reference's parsed statement / expression nodes
(reference src/parser/): a compact dataclass hierarchy bridging the parser
and the binder.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ColumnRef:
    table: str | None
    name: str


@dataclasses.dataclass
class Literal:
    value: Any
    type_hint: str | None = None  # 'date' | 'interval_day' | ...


@dataclasses.dataclass
class IntervalLit:
    value: int
    unit: str  # day | month | year


@dataclasses.dataclass
class BinaryOp:
    op: str
    left: Any
    right: Any


@dataclasses.dataclass
class UnaryOp:
    op: str  # not | -
    child: Any


@dataclasses.dataclass
class FuncCall:
    name: str
    args: list
    distinct: bool = False
    star: bool = False  # count(*)


@dataclasses.dataclass
class WindowExpr:
    """<func>(args) OVER (PARTITION BY ... ORDER BY ... [frame])."""
    func: str
    args: list
    partition_by: list
    order_by: list                  # [OrderItem]
    frame: str | None = None        # rows_upto | range_upto | partition
    star: bool = False              # count(*) OVER (...)


@dataclasses.dataclass
class CaseExpr:
    whens: list  # [(cond, result)]
    default: Any


@dataclasses.dataclass
class BetweenExpr:
    expr: Any
    low: Any
    high: Any
    negated: bool = False


@dataclasses.dataclass
class InExpr:
    expr: Any
    values: Any  # list of literals or SelectStmt
    negated: bool = False


@dataclasses.dataclass
class LikeExpr:
    expr: Any
    pattern: str
    negated: bool = False


@dataclasses.dataclass
class ExistsExpr:
    query: "SelectStmt"
    negated: bool = False


@dataclasses.dataclass
class IsNullExpr:
    expr: Any
    negated: bool = False  # IS NOT NULL


@dataclasses.dataclass
class SubqueryExpr:
    query: "SelectStmt"


@dataclasses.dataclass
class ExtractExpr:
    field: str
    child: Any


@dataclasses.dataclass
class SubstringExpr:
    child: Any
    start: Any
    length: Any


@dataclasses.dataclass
class CastExpr:
    child: Any
    target: str


@dataclasses.dataclass
class CreateTableAs:
    name: str
    select: Any


@dataclasses.dataclass
class SelectItem:
    expr: Any
    alias: str | None


@dataclasses.dataclass
class TableRef:
    name: str
    alias: str | None
    subquery: "SelectStmt | None" = None
    column_aliases: list | None = None
    func_args: list | None = None       # table function: range(...)


@dataclasses.dataclass
class OrderItem:
    expr: Any
    descending: bool


@dataclasses.dataclass
class SelectStmt:
    items: list[SelectItem]
    tables: list[TableRef]
    where: Any | None
    group_by: list
    having: Any | None
    order_by: list[OrderItem]
    limit: int | None
    distinct: bool = False
    # non-recursive WITH ctes: list of (name, column_aliases|None, SelectStmt)
    ctes: list | None = None


# ------------------------------------------------------- DDL/DML statements
# (analog of the reference's non-SELECT statement nodes, src/parser/statement/)


@dataclasses.dataclass
class ColumnDef:
    name: str
    type_name: str           # integer|bigint|double|decimal|date|varchar|char
    params: list             # e.g. DECIMAL(12, 2) -> [12, 2]


@dataclasses.dataclass
class CreateTable:
    name: str
    columns: list[ColumnDef]


@dataclasses.dataclass
class CreateIndex:
    name: str | None
    table: str
    column: str
    using: str = "cubit"     # cubit (bitmap) | pk (direct-address)
    n_bins: int | None = None


@dataclasses.dataclass
class Insert:
    table: str
    columns: list[str] | None
    rows: list[list]         # literal expressions per row
    select: "SelectStmt | None" = None


@dataclasses.dataclass
class Delete:
    table: str
    where: Any | None


@dataclasses.dataclass
class Update:
    table: str
    assignments: list        # [(column, expr)]
    where: Any | None


@dataclasses.dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class SetStmt:
    name: str
    value: Any


@dataclasses.dataclass
class TransactionStmt:
    kind: str                # begin | commit | rollback


@dataclasses.dataclass
class ExplainStmt:
    query: "SelectStmt"
    analyze: bool = False


@dataclasses.dataclass
class PragmaStmt:
    name: str
    args: list
