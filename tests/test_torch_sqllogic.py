"""The sqllogictest corpus on the torch port, on the CPU.

The runner is the port's byte-identical copy of `testing/sqllogic.py`; each
file of `testing/sqllogic_gate.FILES` (every committed file that needs no
part the port lacks) runs on a fresh CPU connection of the port and must
pass as it passes on the reference.  Each file left out must be named in
ROADMAP.md with its reason (the missing golden answers, a reference
fault).  The runner's `load` / `restart` reopen a database
with `storage.persist.open_database`, which takes the card unless asked for
another device: here it is asked for the CPU.
"""

import functools
import glob
import os

import pytest

from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.storage import persist
from duckdb_cubit_tpu_torch.testing import sqllogic_gate
from duckdb_cubit_tpu_torch.testing.sqllogic import run_file

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FILES = [os.path.join("sqllogic", f) for f in sqllogic_gate.FILES]


@pytest.mark.parametrize("rel", FILES, ids=[os.path.basename(f)
                                            for f in FILES])
def test_sqllogic_file_on_the_port(rel, monkeypatch):
    monkeypatch.setattr(persist, "open_database", functools.partial(
        persist.open_database, device="cpu"))
    report = run_file(os.path.join(HERE, rel), conn=Connection(device="cpu"))
    assert not report.skipped
    assert report.executed > 0


def test_every_left_out_file_is_named_in_the_roadmap():
    listed = {os.path.basename(f) for f in FILES}
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    everything = glob.glob(os.path.join(HERE, "sqllogic", "*.test")) + \
        glob.glob(os.path.join(HERE, "sqllogic", "ported", "*.test"))
    missing = sorted(os.path.basename(p) for p in everything
                     if os.path.basename(p) not in listed
                     and os.path.basename(p).removesuffix(".test")
                     not in roadmap)
    assert not missing, missing
