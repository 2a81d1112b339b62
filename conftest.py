"""Test order for the whole repository (tests/conftest.py configures the
suite itself).

Under `--dist loadfile` xdist runs all of a file's tests in order on one
worker, so the suite's wall time is set by its longest file chain and by
when that chain starts, not by its total work. LONG_FILES are the files
over about 300 s of worker time, longest first; they go to the front of the
collection, and xdist keeps the collection order, so each starts at once on
a worker of its own. The multichip checks compile cold in every run (their
subprocesses keep no cache), so no warm cache shortens them.
"""

LONG_FILES = ("test_multichip.py", "test_stream.py", "test_session_variants.py",
              "test_pallas_stencil.py", "test_pipeline.py")


def pytest_configure(config):
    # xdist's loadfile hands files out by test count, most first, unless
    # told to keep the collection order (--no-loadscope-reorder)
    config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    rank = {name: i for i, name in enumerate(LONG_FILES)}
    last = len(LONG_FILES)
    items.sort(key=lambda item: rank.get(item.path.name, last)
               if item.path.parent.name == "tests" else last)
