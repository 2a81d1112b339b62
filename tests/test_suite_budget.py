"""Every wait in tests/ has a limit of its own under the tier-1 run's 1470 s.

A subprocess or thread that outlasts the run cannot fail as one named test:
the run is cut, and every test after it on that worker is lost. So every
subprocess wait passes a `timeout`, every thread or process join and wait
passes one, and every literal timeout in tests/ is at most MAX_TIMEOUT_S.

FROZEN lists the waits that break these rules in the JAX package's own test
files, which the repository keeps as they were; each check asserts that its
offenders are exactly those, so a new offender fails, and so does an entry
whose wait has gone."""

import ast
import functools
from pathlib import Path

TESTS = Path(__file__).resolve().parent
MAX_TIMEOUT_S = 1200
SUBPROCESS_WAITS = {"run", "check_output", "check_call", "call"}
JOINS = {"join", "wait"}  # with no argument, str.join and os.path.join have one or more
FROZEN = {
    "unbounded subprocess": set(),
    "unbounded join": {"test_session_variants.py:85"},
    "over budget": {("test_multichip.py:30", 2100), ("test_multichip.py:49", 3000)},
}


@functools.cache
def _calls() -> tuple:
    """(place, call, {local name: name} of its file's imports from subprocess)
    of every call."""
    found = []
    for path in sorted(TESTS.glob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        imported = {alias.asname or alias.name: alias.name for node in ast.walk(tree)
                    if isinstance(node, ast.ImportFrom) and node.module == "subprocess"
                    for alias in node.names}
        found += [(f"{path.name}:{node.lineno}", node, imported)
                  for node in ast.walk(tree) if isinstance(node, ast.Call)]
    return tuple(found)


def _is_subprocess_wait(call: ast.Call, imported: dict) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return imported.get(f.id) in SUBPROCESS_WAITS
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "communicate":
        return True
    return (f.attr in SUBPROCESS_WAITS and isinstance(f.value, ast.Name)
            and f.value.id == "subprocess")


def _is_join(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute) and call.func.attr in JOINS


def _timeout(call: ast.Call):
    """The call's `timeout=`, or a join's or wait's first argument."""
    kw = next((kw.value for kw in call.keywords if kw.arg == "timeout"), None)
    if kw is None and _is_join(call) and call.args:
        return call.args[0]
    return kw


def test_every_subprocess_wait_has_a_timeout():
    unbounded = {where for where, call, imported in _calls()
                 if _is_subprocess_wait(call, imported) and _timeout(call) is None}
    assert unbounded == FROZEN["unbounded subprocess"], \
        f"subprocess waits without a timeout: {sorted(unbounded)}"


def test_every_join_and_wait_has_a_timeout():
    unbounded = {where for where, call, _ in _calls()
                 if _is_join(call) and not call.args and not call.keywords}
    assert unbounded == FROZEN["unbounded join"], \
        f"joins and waits without a timeout: {sorted(unbounded)}"


def test_every_literal_timeout_is_under_the_budget():
    over = {(where, value.value) for where, call, _ in _calls()
            if isinstance(value := _timeout(call), ast.Constant)
            and isinstance(value.value, (int, float)) and value.value > MAX_TIMEOUT_S}
    assert over == FROZEN["over budget"], f"timeouts over {MAX_TIMEOUT_S} s: {sorted(over)}"
