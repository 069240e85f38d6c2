#!/usr/bin/env python
"""One-command run of the benchmark config suite, one row after another.

Runs every row of the BASELINE config suite + texture tiers + the neural
surrogate through `bench.py`, each in its own subprocess, one after the
other on one GPU, collects the one-line JSON results, writes
`measurements/bench_suite_<ts>.json`, and prints a Markdown table.

Rows measured by ONE invocation of this script share a card and its power
limit, so they are mutually comparable — that is its point. Reference analog: the
tagged `--perf-log` CSV comparison workflow (reference src/main.rs:200-262),
promoted to a push-button suite.

Usage:
  python scripts/bench_suite.py               # full suite
  python scripts/bench_suite.py --quick       # headline/exact/texture rows
  python scripts/bench_suite.py --only kerr   # name-substring filter
  python scripts/bench_suite.py --list        # show rows and exit
"""

import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# (name, env overrides, in --quick subset). FRAMES trimmed for the slow 4K
# stress row.
SUITE = [
    ("headline_1080p", {}, True),
    ("headline_1080p_xla_oracle", {"BHR_BENCH_ORACLE": "1"}, True),
    ("default_800x600", {"BHR_BENCH_W": "800", "BHR_BENCH_H": "600"}, False),
    ("multires2_1080p", {"BHR_BENCH_MULTIRES": "2"}, False),
    ("multires3_1080p", {"BHR_BENCH_MULTIRES": "3"}, False),
    (
        "config4_rk4_adaptive_disk",
        {
            "BHR_BENCH_INTEGRATOR": "rk4",
            "BHR_BENCH_ADAPTIVE": "1",
            "BHR_BENCH_DISK": "1",
        },
        False,
    ),
    (
        "config4_multires3",
        {
            "BHR_BENCH_INTEGRATOR": "rk4",
            "BHR_BENCH_ADAPTIVE": "1",
            "BHR_BENCH_DISK": "1",
            "BHR_BENCH_MULTIRES": "3",
        },
        False,
    ),
    (
        "config5_4k_kerr_stress",
        {
            "BHR_BENCH_W": "3840",
            "BHR_BENCH_H": "2160",
            "BHR_BENCH_STEPS": "2000",
            "BHR_BENCH_MODEL": "kerr",
            "BHR_BENCH_DISK": "1",
            "BHR_BENCH_FRAMES": "30",
        },
        False,
    ),
    (
        "texture_nearest_sub2",
        {"BHR_BENCH_TEXTURE": "nearest", "BHR_BENCH_TEXSUB": "2"},
        True,
    ),
    (
        "texture_bilinear_checker",
        {"BHR_BENCH_TEXTURE": "bilinear", "BHR_BENCH_TEXSUB": "checker"},
        False,
    ),
    ("texture_bilinear_exact", {"BHR_BENCH_TEXTURE": "bilinear"}, True),
    ("texture_nearest_full", {"BHR_BENCH_TEXTURE": "nearest"}, False),
    (
        "texture_nearest_sub2_multires3",
        {
            "BHR_BENCH_TEXTURE": "nearest",
            "BHR_BENCH_TEXSUB": "2",
            "BHR_BENCH_MULTIRES": "3",
        },
        False,
    ),
    ("texture_luma_sub4", {"BHR_BENCH_TEXTURE": "luma", "BHR_BENCH_TEXSUB": "4"}, False),
    ("texture_luma_full", {"BHR_BENCH_TEXTURE": "luma"}, False),
    ("neural_surrogate", {"BHR_BENCH_INTEGRATOR": "neural"}, False),
    (
        "neural_xl",
        {
            "BHR_BENCH_INTEGRATOR": "neural",
            "BHR_BENCH_NEURAL_WEIGHTS": "bhr_tpu/assets/neural_schwarzschild_orbit_xl.npz",
        },
        False,
    ),
    (
        "neural_highest",
        {
            "BHR_BENCH_INTEGRATOR": "neural",
            "BHR_BENCH_NEURAL_PRECISION": "highest",
        },
        False,
    ),
    (
        "neural_texture_luma2",
        {
            "BHR_BENCH_INTEGRATOR": "neural",
            "BHR_BENCH_TEXTURE": "luma",
            "BHR_BENCH_TEXSUB": "2",
            "BHR_BENCH_NEURAL_WEIGHTS": "bhr_tpu/assets/neural_schwarzschild_orbit.npz",
        },
        False,
    ),
    (
        # the general Kerr surrogate at its bf16 training tier
        "kerr_neural",
        {
            "BHR_BENCH_INTEGRATOR": "neural",
            "BHR_BENCH_MODEL": "kerr",
            "BHR_BENCH_NEURAL_WEIGHTS": "bhr_tpu/assets/neural_kerr.npz",
        },
        False,
    ),
    (
        # the fp32-trained per-scene distilled asset at its matched tier
        # (auto resolves fp32-at-HIGHEST from the train_precision meta)
        "kerr_neural_distilled",
        {
            "BHR_BENCH_INTEGRATOR": "neural",
            "BHR_BENCH_MODEL": "kerr",
            "BHR_BENCH_NEURAL_WEIGHTS": "bhr_tpu/assets/neural_kerr_default.npz",
        },
        False,
    ),
    (
        # the runtime-plugin physics tier (model="custom" — the --shader
        # hot-swap analog)
        "plugin_paczynski_wiita",
        {"BHR_BENCH_PLUGIN": "examples/plugins/paczynski_wiita.py"},
        False,
    ),
]

# Inherited env keys that silently change what bench.py measures. They are
# stripped from every row's subprocess env (the row overrides are the ONLY
# BHR_* knobs in effect) so a stray `BHR_BENCH_ORACLE=1` in the caller's
# shell cannot make a run look canonical while measuring something else.
_KNOB_PREFIXES = ("BHR_BENCH_", "BHR_TEX_SCRAMBLE")


def _clean_env(overrides):
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(_KNOB_PREFIXES)
    }
    dropped = sorted(k for k in os.environ if k.startswith(_KNOB_PREFIXES))
    env.update(overrides)
    return env, dropped


def run_row(name, overrides, timeout_s):
    env, dropped = _clean_env(overrides)
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout_s,
        cwd=str(REPO),
    )
    result, error = None, None
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            cand = json.loads(line)
        except json.JSONDecodeError:
            continue
        # bench.py's result line is a dict with a numeric "value"; anything
        # else (a stray printed number, a partial dict) must not be accepted
        # or the table formatting below would crash the whole suite.
        if isinstance(cand, dict) and isinstance(cand.get("value"), (int, float)):
            result = cand
            break
    if proc.returncode != 0 or result is None:
        error = (proc.stderr or proc.stdout).strip()[-2000:]
    return {
        "name": name,
        "env": overrides,
        "dropped_inherited_env": dropped or None,
        "result": result,
        "error": error,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="headline+texture subset")
    ap.add_argument("--only", help="run rows whose name contains this substring")
    ap.add_argument("--list", action="store_true", help="list rows and exit")
    ap.add_argument(
        "--timeout", type=int, default=1800, help="per-row subprocess timeout (s)"
    )
    ap.add_argument("--out", help="output JSON path (default measurements/...)")
    args = ap.parse_args(argv)

    rows = SUITE
    if args.quick:
        rows = [r for r in rows if r[2]]
    if args.only:
        rows = [r for r in rows if args.only in r[0]]
    if args.list or not rows:
        for name, overrides, quick in rows:
            print(f"{name:32s} {'[quick] ' if quick else ''}{overrides}")
        return 0

    stray = sorted(k for k in os.environ if k.startswith(_KNOB_PREFIXES))
    if stray:
        print(
            f"note: ignoring inherited knobs {', '.join(stray)} — each row "
            "runs with exactly its declared overrides",
            file=sys.stderr,
        )

    started = datetime.datetime.now(datetime.timezone.utc)
    ts = started.strftime("%Y%m%d_%H%M%S")
    path = pathlib.Path(
        args.out or REPO / "measurements" / f"bench_suite_{ts}.json"
    )
    path.parent.mkdir(parents=True, exist_ok=True)

    out = []

    def write_payload():
        # incremental: a crash or ctrl-C mid-suite keeps every finished row
        payload = {
            "started_utc": started.isoformat(),
            "finished_utc": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
            "single_session": True,
            "rows": out,
        }
        path.write_text(json.dumps(payload, indent=1))

    for i, (name, overrides, _) in enumerate(rows):
        print(f"[{i + 1}/{len(rows)}] {name} ...", flush=True)
        try:
            row = run_row(name, overrides, args.timeout)
        except subprocess.TimeoutExpired:
            row = {"name": name, "env": overrides, "result": None,
                   "error": f"timeout after {args.timeout}s"}
        out.append(row)
        write_payload()
        r = row["result"]
        if r:
            print(
                f"    {r['value']:.2f} ms/frame  runs={r.get('ms_per_frame')}  "
                f"{r.get('mray_steps_per_sec', 0) / 1000.0:.1f} Gray-steps/s",
                flush=True,
            )
        else:
            print(f"    FAILED: {row['error'][:200]}", flush=True)

    print(f"\nwrote {path}\n")

    print("| row | median ms/frame | runs | Gray-steps/s |")
    print("|---|---:|---|---:|")
    for row in out:
        r = row["result"]
        if r:
            print(
                f"| {row['name']} | **{r['value']:.2f}** | {r.get('ms_per_frame')} "
                f"| {r.get('mray_steps_per_sec', 0) / 1000.0:.1f} |"
            )
        else:
            print(f"| {row['name']} | FAILED | | |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
