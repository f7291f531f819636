"""The port's placement-only launchers against the reference's examples:
``python -m repro_torch.launch.quickstart`` and
``python -m repro_torch.launch.compaction_demo`` must log the same lines as
``examples/quickstart.py`` and ``examples/compaction_demo.py`` on the same
seed.

Both quickstarts solve the WPM MIP with a 10 s limit; the MIP itself is held
to its optimum here (the limit is lifted in both packages alike and each
solve must report ``optimal``), so a loaded machine cannot make one package
stop early.  ``sys.argv`` and ``logging.basicConfig`` are replaced through
``monkeypatch``.
"""
import importlib.util
import logging
from pathlib import Path

import pytest

from repro_torch.launch import compaction_demo, quickstart

ROOT = Path(__file__).resolve().parents[1]


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(caplog, logger_name):
    return [r.getMessage() for r in caplog.records if r.name == logger_name]


def _solve_to_optimum(monkeypatch, module, statuses):
    real = module.solve_wpm

    def solve(*args, **kw):
        res = real(*args, **dict(kw, time_limit=600.0))
        statuses.append(res.status)
        return res

    monkeypatch.setattr(module, "solve_wpm", solve)


@pytest.mark.parametrize("name,twin", [("quickstart", quickstart),
                                       ("compaction_demo", compaction_demo)])
def test_launcher_logs_the_reference_examples_lines(name, twin, monkeypatch, caplog):
    ref = _reference_example(name)
    statuses = []
    if name == "quickstart":
        for mod in (ref, twin):
            _solve_to_optimum(monkeypatch, mod, statuses)
    monkeypatch.setattr("sys.argv", [f"{name}.py"])
    # both mains call logging.basicConfig, which would otherwise leave a root
    # handler installed for the rest of the process wherever none was set
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: None)
    with caplog.at_level(logging.INFO, logger=ref.log.name), \
            caplog.at_level(logging.INFO, logger=twin.log.name):
        ref.main()
        assert twin.main([]) == 0
    want, got = _lines(caplog, ref.log.name), _lines(caplog, twin.log.name)
    assert got == want
    assert len(got) >= 8
    assert statuses == ["optimal"] * (4 if name == "quickstart" else 0)
