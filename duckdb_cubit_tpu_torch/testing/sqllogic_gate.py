"""The sqllogictest files the port runs, as paths under `tests/sqllogic/`.

Every committed file that needs no part the port lacks: the authored files
and the ported reference files, verification (`PRAGMA enable_verification`)
and out-of-core mode (`force_external`) included, without the golden TPC-H
answers.  `tests/test_torch_sqllogic.py` runs them on the CPU and
`chip_smoke.py` on the card; ROADMAP.md names each file left out and why.
"""

AUTHORED = ["aggregates", "asof_outer", "case_exprs", "dates", "ddl_dml",
            "decimals", "distinct", "dml_index_cycle", "empty_groups",
            "external_mode", "filters", "functions", "index", "joins",
            "limit_dml", "null_ordering", "outer_join_nulls", "scalar_math",
            "settings", "stats_functions", "string_functions",
            "transactions", "verification_mode", "window", "window_frames"]
PORTED = [
    "aggregate__aggregates__test_null_aggregates",
    "aggregate__group__test_group_by_large_string",
    "aggregate__group__test_group_by_multi_column",
    "aggregate__group__test_group_null",
    "alter__alter_type__test_alter_type_incorrect",
    "alter__drop_col__test_drop_col_index",
    "alter__rename_col__test_rename_col_failure",
    "alter__rename_table__test_rename_table_incorrect",
    "catalog__test_incorrect_table_creation",
    "collate__test_unsupported_collations",
    "conjunction__or_between",
    "constraints__primarykey__test_pk_rollback",
    "constraints__primarykey__test_pk_updel_local",
    "cte__insert_cte_bug_3417",
    "cte__materialized__recursive_cte_error_materialized",
    "cte__recursive_cte_error",
    "delete__test_delete",
    "error__mix_aggregate_and_non_aggregate",
    "filter__filter_cache",
    "filter__test_constant_comparisons",
    "filter__test_illegal_filters",
    "function__numeric__test_pow",
    "function__string__test_issue_1812",
    "index__art__nodes__test_art_prefixes_restart",
    "index__art__storage__test_art_storage_multi_checkpoint",
    "insert__insert_rollback",
    "join__inner__join_cross_product",
    "join__inner__test_lt_join",
    "json__issues__large_quoted_string_constant",
    "optimizer__plan__test_table_filter_pushdown",
    "order__test_order_large",
    "select__test_select_into",
    "select__test_select_locking",
    "storage__test_empty_table",
    "storage__test_storage_scan",
    "subquery__table__test_aliasing",
    "table_function__range_function_different_iterators",
    "topn__test_top_n_medium",
    "transactions__test_stacked_schema_change",
    "transactions__test_transaction_local_data",
    "transactions__transaction_errors",
    "types__nested__map__map_from_entries__invalid",
    "types__null__test_null_aggr",
    "update__update_after_commit",
    "window__test_window_binding",
]
FILES = [f"{n}.test" for n in AUTHORED] + \
    [f"ported/{n}.test" for n in PORTED]
