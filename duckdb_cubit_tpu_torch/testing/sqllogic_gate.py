"""The sqllogictest files the port runs, as paths under `tests/sqllogic/`.

Every committed file that needs no part the port lacks: the authored files
and the ported reference files without verification, out-of-core mode or
the golden TPC-H answers.  `tests/test_torch_sqllogic.py` runs them on the
CPU and `chip_smoke.py` on the card; ROADMAP.md names each file left out
with the item that brings what it needs.
"""

AUTHORED = ["aggregates", "asof_outer", "case_exprs", "dates", "ddl_dml",
            "decimals", "distinct", "dml_index_cycle", "empty_groups",
            "filters", "functions", "index", "joins", "limit_dml",
            "null_ordering", "outer_join_nulls", "scalar_math",
            "stats_functions", "string_functions", "transactions", "window",
            "window_frames"]
PORTED = [
    "aggregate__group__test_group_by_multi_column",
    "aggregate__group__test_group_null",
    "alter__alter_type__test_alter_type_incorrect",
    "alter__drop_col__test_drop_col_index",
    "alter__rename_col__test_rename_col_failure",
    "alter__rename_table__test_rename_table_incorrect",
    "catalog__test_incorrect_table_creation",
    "collate__test_unsupported_collations",
    "constraints__primarykey__test_pk_rollback",
    "constraints__primarykey__test_pk_updel_local",
    "error__mix_aggregate_and_non_aggregate",
    "index__art__nodes__test_art_prefixes_restart",
    "index__art__storage__test_art_storage_multi_checkpoint",
    "insert__insert_rollback",
    "json__issues__large_quoted_string_constant",
    "order__test_order_large",
    "select__test_select_into",
    "select__test_select_locking",
    "storage__test_empty_table",
    "storage__test_storage_scan",
    "table_function__range_function_different_iterators",
    "transactions__test_stacked_schema_change",
    "transactions__transaction_errors",
    "types__null__test_null_aggr",
]
FILES = [f"{n}.test" for n in AUTHORED] + \
    [f"ported/{n}.test" for n in PORTED]
