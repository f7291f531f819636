"""Host-contention guard: is this machine quiet enough to trust timings?

Benchmark numbers taken on a loaded host are noise dressed as data — a
stale ``pytest`` from a previous session or a concurrent bench run steals
cycles and inflates every percentile.  The bench entrypoints
(``benchmarks/kernel_bench.py``, ``benchmarks/calibrate.py``,
``benchmarks/placement_bench.py``) call :func:`host_snapshot` before
timing anything, log a warning when the host looks contended, and record
the snapshot (including the ``contended`` flag) in their JSON reports so
downstream consumers — the :mod:`benchmarks.validate_bench` regression
gate in particular — can discount or reject polluted runs.

Detection is deliberately cheap and dependency-free:

* 1-minute load average vs. CPU count (``os.getloadavg``);
* a ``/proc`` scan for *other* processes whose command lines look like
  test or bench runs (``pytest``, ``benchmarks.*``, ``calibrate``).

Neither signal is perfect — the load average lags by design and ``/proc``
is Linux-only (elsewhere the scan degrades to "no competitors found") —
but together they catch the common failure mode: forgotten runs from a
previous session still burning CPU when a new measurement starts.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

__all__ = ["COMPETING_PATTERNS", "competing_processes", "host_snapshot"]

log = logging.getLogger("repro_torch.obs.host")

#: command-line substrings that mark a process as a timing competitor.
COMPETING_PATTERNS: tuple = (
    "pytest",
    "benchmarks.kernel_bench",
    "benchmarks.placement_bench",
    "benchmarks.calibrate",
    "benchmarks.solver_scaling",
)

#: load1 / n_cpus above this fraction counts as contended even with no
#: recognizable competitor (something else is eating the machine).
_LOAD_FRACTION_THRESHOLD = 0.75


def competing_processes(
    patterns: Sequence[str] = COMPETING_PATTERNS,
    exclude_pids: Optional[Sequence[int]] = None,
) -> List[Dict[str, object]]:
    """Other live processes whose cmdline matches a bench/test pattern.

    The calling process (and any explicit ``exclude_pids``, e.g. parent
    test runners that legitimately wrap the bench) are skipped.  Returns
    ``[{"pid": int, "cmdline": str}, ...]``; empty on non-Linux hosts.
    """
    skip = {os.getpid()}
    skip.update(exclude_pids or ())
    # walking up the parent chain excludes the pytest that *launched* us
    # (a test invoking the bench in-process is not contention).
    try:
        pid = os.getppid()
        while pid > 1 and len(skip) < 32:
            skip.add(pid)
            with open(f"/proc/{pid}/stat") as f:
                pid = int(f.read().split()[3])
    except (OSError, ValueError, IndexError):
        pass

    out: List[Dict[str, object]] = []
    try:
        pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return out
    for pid in pids:
        if pid in skip:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue  # raced with process exit
        if cmd and any(p in cmd for p in patterns):
            out.append({"pid": pid, "cmdline": cmd[:200]})
    return out


def host_snapshot(warn: bool = True) -> Dict[str, object]:
    """Contention snapshot for a bench report's ``host`` section.

    Keys: ``load1`` (1-minute load average, None where unsupported),
    ``n_cpus``, ``competing`` (pid/cmdline rows), and the verdict
    ``contended`` — True when competitors exist or load1 exceeds
    75% of the CPU count.
    """
    try:
        load1 = float(os.getloadavg()[0])
    except (OSError, AttributeError):
        load1 = None
    n_cpus = os.cpu_count() or 1
    competing = competing_processes()
    contended = bool(competing) or (
        load1 is not None and load1 >= _LOAD_FRACTION_THRESHOLD * n_cpus
    )
    snap: Dict[str, object] = {
        "load1": load1,
        "n_cpus": n_cpus,
        "competing": competing,
        "contended": contended,
    }
    if warn and contended:
        who = ", ".join(str(c["pid"]) for c in competing) or "high load"
        log.warning(
            "host looks CONTENDED (load1=%s over %d cpu(s); %s) — timings "
            "in this report are suspect; report carries contended=true",
            f"{load1:.2f}" if load1 is not None else "?", n_cpus, who,
        )
    return snap
