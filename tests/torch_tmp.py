"""Disk hygiene for the port's tests.

A test's ``tmp_path`` can hold checkpoints of ~60-500 MB (a small model
with its Adam state, fenet's and the port's), deploy files and synthetic
trees. pytest keeps the basetemps of the last three runs, so a whole run of
the port's tests once left ~5 GB behind. A test module that imports
:func:`remove_tmp_path` deletes each test's ``tmp_path`` once the test has
run; module-scoped trees are deleted by their own fixtures.
"""

import shutil

import pytest


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    """Delete the test's ``tmp_path``, if it asked for one, after the test
    (its assertions have run by then, passed or failed)."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
