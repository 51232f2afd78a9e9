from .sqllogic import SqlLogicError, run_file, run_script  # noqa: F401
