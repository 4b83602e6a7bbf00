"""Benchmark-result regression guard of the port.

The port of ``benchmarks/check_regression.py``, with the reference's rules
unchanged. It re-reads the rows under ``benchmarks_torch/results/`` (the
drivers' ``<name>.json`` and the system benchmarks' ``BENCH_<name>.json``
alike) and fails when

  * a results file contains an empty row list (the sweep produced nothing),
  * any numeric value in any row is NaN,
  * any numeric value is +/-inf — except keys where infinity is a
    legitimate sentinel (``clip=inf`` means clipping disabled).

Usage::

    python benchmarks_torch/check_regression.py [paths...] [--trajectory]
        [--baseline-rev REV] [--tolerance X]

Serving/latency columns get a stronger rule: a latency percentile or a
throughput that is zero (or negative) means the run measured nothing, so
``POSITIVE_KEYS`` must be finite AND strictly positive.

**Trajectory mode** (``--trajectory``) additionally compares each
committed ``BENCH_*.json`` against the *previous git revision of the same
file*: rows are matched on their configuration identity (string fields
plus the sweep's integer knobs) and the perf columns in
``TRAJECTORY_DIRECTIONS`` must not be worse than baseline by more than
the tolerance band (``--tolerance``, default 1.5 = 50% slack — shared CI
runners are noisy; CI invokes with a wider band). Lower-is-better columns
(latencies, build times, RSS) fail when ``cur > base * tol``;
higher-is-better columns (throughput, rounds/s) fail when
``cur < base / tol``. The baseline is ``HEAD``'s version when the working
copy differs from it (the normal CI case: the bench just rewrote the
file), else the version before the last commit that touched it.

Override knob for *intentional* regressions: set
``REPRO_BENCH_ALLOW_REGRESSION=1`` (or pass ``--allow-regression``) to
downgrade trajectory failures to warnings — use it on the one commit that
knowingly trades perf, then drop it so the new numbers become the
baseline. ``REPRO_BENCH_TOLERANCE`` overrides the default band.

``paths`` may be JSON files or directories (searched for ``*.json``);
default is ``benchmarks_torch/results``, where the port's ``BENCH_*.json``
artifacts live (the repo root's are the reference's; telemetry
``*_trace.json`` companions are trace artifacts, not row lists, and are
skipped). A results file git has never committed has no trajectory
baseline: that is a note, not a failure.
Exits non-zero with one line per problem found.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
from typing import Dict, Iterator, List, Optional, Tuple

RESULTS_DIR = pathlib.Path(__file__).parent / "results"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

# Keys where an infinite value is a configuration sentinel, not a broken
# metric (privacy rows serialise clip=inf for "clipping disabled").
INF_OK_KEYS = {"clip"}

# Latency/throughput columns: zero means the run measured nothing (an empty
# stream or a broken clock), so these must be finite and strictly positive.
# The graph-scaling columns (BENCH_graph.json) are held to the same rule: a
# zero build time or forward time means the size was skipped, not measured.
POSITIVE_KEYS = {
    "p50_ms", "p99_ms", "throughput_qps", "mean_batch",
    "build_s", "kernel_forward_us", "bucketed_forward_us",
    "csr_mb", "dense_over_csr",
    "rounds_per_s", "peak_rss_mb",
}

# Epsilon keys: inf is correct ONLY for a no-noise baseline row (sigma=0
# means no DP, hence unbounded epsilon); anywhere else it is a regression.
EPSILON_KEYS = {"epsilon", "epsilon_vs_server", "pack_epsilon"}
NOISE_KEYS = ("noise_multiplier", "pack_noise_multiplier")

# Privacy-audit curves (BENCH_privacy.json): the empirical attack must see
# the DP noise. The no-noise endpoint (largest epsilon, normally inf) has
# to leak strictly more than the tightest-epsilon endpoint — a flat or
# inverted curve means either the attack or the mechanism is broken.
ATTACK_KEY = "attack_advantage"

# Trajectory mode: perf columns compared against the previous git revision
# of the same BENCH file, with the direction that counts as "better".
TRAJECTORY_DIRECTIONS = {
    "p50_ms": "lower",
    "p99_ms": "lower",
    "build_s": "lower",
    "kernel_forward_us": "lower",
    "bucketed_forward_us": "lower",
    "peak_rss_mb": "lower",
    "throughput_qps": "higher",
    "rounds_per_s": "higher",
}
DEFAULT_TOLERANCE = float(os.environ.get("REPRO_BENCH_TOLERANCE", "1.5"))

# Integer fields that identify a sweep point (as opposed to being measured
# quantities like batch counts): rows are matched across revisions on
# their string fields plus these.
CONFIG_INT_KEYS = {
    "clients", "num_clients", "max_batch_size", "devices", "rounds",
    "num_nodes", "block_n", "degree", "heads", "lanes", "padded_degree",
    "local_steps", "seed", "K", "H", "r",
}


def row_identity(row) -> Tuple:
    """A row's configuration identity: every string/bool field plus the
    whitelisted integer knobs. Measured ints (batch counts, cache hits)
    are deliberately excluded so a perf change cannot unmatch a row."""
    if not isinstance(row, dict):
        return (repr(row),)
    ident = []
    for k in sorted(row):
        v = row[k]
        if isinstance(v, bool) or isinstance(v, str):
            ident.append((k, v))
        elif isinstance(v, int) and k in CONFIG_INT_KEYS:
            ident.append((k, v))
    return tuple(ident)


def compare_rows(cur, base, tolerance: float, label: str = "") -> List[str]:
    """Trajectory comparison of one matched row pair. Returns one problem
    string per perf column outside its tolerance band."""
    problems: List[str] = []
    if not (isinstance(cur, dict) and isinstance(base, dict)):
        return problems
    for key, direction in TRAJECTORY_DIRECTIONS.items():
        a, b = cur.get(key), base.get(key)
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            continue
        if isinstance(a, bool) or isinstance(b, bool):
            continue
        if not (math.isfinite(a) and math.isfinite(b)) or a <= 0 or b <= 0:
            continue  # the base checks already police these
        if direction == "lower" and a > b * tolerance:
            problems.append(
                f"{label}{key} regressed: {a:.6g} > {b:.6g} * {tolerance:g} "
                f"(lower is better)"
            )
        elif direction == "higher" and a < b / tolerance:
            problems.append(
                f"{label}{key} regressed: {a:.6g} < {b:.6g} / {tolerance:g} "
                f"(higher is better)"
            )
    return problems


def check_trajectory_rows(
    cur_rows: List, base_rows: List, tolerance: float
) -> Tuple[List[str], int]:
    """Match rows by identity (paired in order within an identity group)
    and compare every matched pair. Returns (problems, matched_count)."""
    by_ident: Dict[Tuple, List] = {}
    for row in base_rows:
        by_ident.setdefault(row_identity(row), []).append(row)
    problems: List[str] = []
    matched = 0
    for i, row in enumerate(cur_rows):
        group = by_ident.get(row_identity(row))
        if not group:
            continue  # new sweep point: nothing to compare against
        base = group.pop(0)
        matched += 1
        problems.extend(compare_rows(row, base, tolerance, f"rows[{i}]."))
    return problems, matched


def _git(args: List[str]) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", *args], cwd=REPO_ROOT, capture_output=True, text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def baseline_rows(path: pathlib.Path, rev: Optional[str]) -> Tuple[Optional[List], str]:
    """The previous-revision content of ``path`` as a row list.

    With ``rev`` given, reads ``rev:path``. Otherwise: the working copy
    differing from HEAD means HEAD *is* the previous revision; an
    unchanged file is compared against the commit before the last one
    that touched it. Returns (rows-or-None, description)."""
    try:
        rel = path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return None, f"{path} is outside the repository"
    if rev is None:
        dirty = _git(["diff", "--quiet", "HEAD", "--", rel]) is None
        if dirty:
            rev = "HEAD"
        else:
            log = _git(["log", "-n", "2", "--format=%H", "HEAD", "--", rel])
            commits = log.split() if log else []
            if len(commits) < 2:
                return None, f"{rel} has no prior revision"
            rev = commits[1]
    blob = _git(["show", f"{rev}:{rel}"])
    if blob is None:
        return None, f"{rel} not present at {rev}"
    try:
        data = json.loads(blob)
    except ValueError as err:
        return None, f"{rel}@{rev} unreadable ({err})"
    return (data if isinstance(data, list) else [data]), rev


def _noise_free_row(row) -> bool:
    """True when the row is a no-DP baseline (every noise knob it carries
    is zero), which legitimises an infinite epsilon."""
    if not isinstance(row, dict):
        return False
    knobs = [row[k] for k in NOISE_KEYS if isinstance(row.get(k), (int, float))]
    return bool(knobs) and all(v == 0 for v in knobs)


def _inf_ok(row, key: str) -> bool:
    if key in INF_OK_KEYS:
        return True
    if key not in EPSILON_KEYS:
        return False
    if _noise_free_row(row):
        return True
    # pack-dp rows never run the update mechanism, so the vs-server update
    # guarantee is (correctly) unbounded there.
    return key == "epsilon_vs_server" and (
        isinstance(row, dict) and row.get("mechanism") == "pack-dp"
    )


def iter_numbers(obj, path: str) -> Iterator[Tuple[str, str, float]]:
    """Yield (path, key, value) for every float-like leaf in a JSON tree."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from iter_numbers(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from iter_numbers(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        yield path, path.rsplit(".", 1)[-1].split("[", 1)[0], obj


def check_attack_curve(rows: List) -> List[str]:
    """Endpoint ordering of an attack-advantage-vs-epsilon sweep.

    Applies only when >= 2 rows carry both an ``epsilon`` and an
    ``attack_advantage`` at distinct epsilons; other files are untouched.
    """
    pts = [
        (row["epsilon"], row[ATTACK_KEY], i)
        for i, row in enumerate(rows)
        if isinstance(row, dict)
        and isinstance(row.get("epsilon"), (int, float))
        and isinstance(row.get(ATTACK_KEY), (int, float))
        and not math.isnan(row["epsilon"])
        and not math.isnan(row[ATTACK_KEY])
    ]
    if len({e for e, _, _ in pts}) < 2:
        return []
    loose = max(pts)  # largest epsilon: weakest guarantee, normally inf
    tight = min(pts)
    if loose[1] > tight[1]:
        return []
    return [
        f"attack curve not monotone: advantage {loose[1]:.6g} at "
        f"eps={loose[0]:g} (rows[{loose[2]}]) must exceed {tight[1]:.6g} "
        f"at eps={tight[0]:g} (rows[{tight[2]}]) — the attack does not "
        "see the DP noise"
    ]


def check_file(path: pathlib.Path) -> List[str]:
    problems: List[str] = []
    try:
        data = json.loads(path.read_text())
    except (ValueError, OSError) as err:
        return [f"{path}: unreadable JSON ({err})"]
    rows = data if isinstance(data, list) else [data]
    if not rows:
        problems.append(f"{path}: empty result list — the sweep produced no rows")
    problems.extend(f"{path}: {p}" for p in check_attack_curve(rows))
    for i, row in enumerate(rows):
        for leaf_path, key, x in iter_numbers(row, f"rows[{i}]"):
            if math.isnan(x):
                problems.append(f"{path}: {leaf_path} is NaN")
            elif math.isinf(x) and not _inf_ok(row, key):
                problems.append(f"{path}: {leaf_path} is {x}")
            elif key in POSITIVE_KEYS and x <= 0:
                problems.append(
                    f"{path}: {leaf_path} is {x} (latency/throughput "
                    "columns must be > 0 — the run measured nothing)"
                )
    return problems


def check_trajectory(
    path: pathlib.Path, rev: Optional[str], tolerance: float
) -> List[str]:
    """Trajectory check of one file against its previous git revision.
    A missing baseline is a note, not a failure — first-ever benchmarks
    and renamed files must not block CI."""
    try:
        cur = json.loads(path.read_text())
    except (ValueError, OSError):
        return []  # check_file already reported it
    cur_rows = cur if isinstance(cur, list) else [cur]
    base, desc = baseline_rows(path, rev)
    if base is None:
        print(f"note: trajectory skipped for {path}: {desc}")
        return []
    problems, matched = check_trajectory_rows(cur_rows, base, tolerance)
    print(
        f"trajectory: {path} vs {desc[:12]}: {matched}/{len(cur_rows)} "
        f"row(s) matched, {len(problems)} regression(s)"
    )
    return [f"{path}: {p}" for p in problems]


def _is_trace_artifact(path: pathlib.Path) -> bool:
    return path.name.endswith("_trace.json")


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*", help="JSON files or directories")
    parser.add_argument(
        "--trajectory", action="store_true",
        help="also compare each file against its previous git revision",
    )
    parser.add_argument(
        "--baseline-rev", default=None, metavar="REV",
        help="explicit git revision for the trajectory baseline",
    )
    parser.add_argument(
        "--tolerance", type=float, default=DEFAULT_TOLERANCE,
        help=f"trajectory tolerance band (default {DEFAULT_TOLERANCE:g})",
    )
    parser.add_argument(
        "--allow-regression", action="store_true",
        default=os.environ.get("REPRO_BENCH_ALLOW_REGRESSION") == "1",
        help="downgrade trajectory failures to warnings",
    )
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    targets = [pathlib.Path(a) for a in args.paths]
    files: List[pathlib.Path] = []
    if not targets:
        targets = [RESULTS_DIR]
    for t in targets:
        if t.is_dir():
            files.extend(sorted(t.glob("*.json")))
        else:
            files.append(t)
    files = [f for f in files if not _is_trace_artifact(f)]
    if not files:
        print(f"check_regression: no result files under {targets}", file=sys.stderr)
        return 1
    problems: List[str] = []
    warnings: List[str] = []
    for f in files:
        problems.extend(check_file(f))
        if args.trajectory:
            found = check_trajectory(f, args.baseline_rev, args.tolerance)
            (warnings if args.allow_regression else problems).extend(found)
    for w in warnings:
        print(f"WARN {w} (allowed by --allow-regression)", file=sys.stderr)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    print(
        f"check_regression: {len(files)} file(s), "
        f"{len(problems)} problem(s)", flush=True,
    )
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
