"""The sqllogictest files the port runs, as paths under `tests/sqllogic/`.

Every committed file that needs no part the port lacks: the authored files
without DML, transactions, persistence, verification, out-of-core mode,
windows or range / asof joins, and the ported reference files likewise.
`tests/test_torch_sqllogic.py` runs them on the CPU and `chip_smoke.py` on
the card; ROADMAP.md names each file left out with the item that brings
what it needs.
"""

AUTHORED = ["aggregates", "case_exprs", "dates", "decimals", "distinct",
            "empty_groups", "filters", "functions", "joins", "null_ordering",
            "outer_join_nulls", "scalar_math", "stats_functions",
            "string_functions"]
PORTED = [
    "aggregate__group__test_group_by_multi_column",
    "aggregate__group__test_group_null",
    "alter__alter_type__test_alter_type_incorrect",
    "alter__drop_col__test_drop_col_index",
    "alter__rename_col__test_rename_col_failure",
    "alter__rename_table__test_rename_table_incorrect",
    "catalog__test_incorrect_table_creation",
    "collate__test_unsupported_collations",
    "error__mix_aggregate_and_non_aggregate",
    "json__issues__large_quoted_string_constant",
    "order__test_order_large",
    "select__test_select_into",
    "select__test_select_locking",
    "table_function__range_function_different_iterators",
    "types__null__test_null_aggr",
]
FILES = [f"{n}.test" for n in AUTHORED] + \
    [f"ported/{n}.test" for n in PORTED]
