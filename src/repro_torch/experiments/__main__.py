"""CLI of the port: run checked-in experiment manifests and inspect their
artifacts.

    PYTHONPATH=src python -m repro_torch.experiments run benchmarks/manifests/expander_periodic.json \
        [--backend dense] [--out results/run_smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.experiments trace results/run_smoke/expander_periodic__dense.json
    PYTHONPATH=src python -m repro_torch.experiments list

`--device` defaults to the CUDA card and fails without one; `--device cpu`
runs on the CPU.

`run` executes the manifest on every backend it declares (or just
`--backend`), prints one summary line per run, and (with --out) writes each
`RunResult` as `<out>/<spec.name>__<backend-kind>[-<engine>].json` -- the
artifact the CI run-smoke job uploads -- plus, per run, a detail event
timeline as `...__<tag>.trace.json` (Perfetto/chrome://tracing loadable)
and `...__<tag>.trace.jsonl` (raw event stream). `trace` renders the phase
breakdown / counters / r-hat-vs-r summary of saved RunResult JSONs.
`list` prints the registries, i.e. every kind a manifest may name.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.experiments import (ExperimentSpec, backends, faultplans,
                                     problems, run, schedules, stepsizes,
                                     topologies)
from repro_torch.obs import Tracer, render_summary, write_chrome_trace, write_jsonl


def _result_tag(result) -> str:
    tag = result.backend.kind
    engine = result.backend.params.get("engine") or result.extras.get("engine")
    if result.backend.kind == "netsim" and engine:
        tag += f"-{engine}"
    if result.backend.params.get("dryrun"):
        tag += "-dryrun"
    return tag


def _cmd_run(args) -> int:
    spec = ExperimentSpec.from_file(args.manifest)
    targets = (spec.backends if args.backend is None
               else [b for b in spec.backends if b.kind == args.backend])
    if not targets:
        print(f"[experiments] manifest {spec.name!r} declares no backend "
              f"{args.backend!r} (has {[b.kind for b in spec.backends]})")
        return 2
    out_dir = pathlib.Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    tags_used: dict[str, int] = {}
    for backend in targets:
        # with --out, capture the full per-event timeline for the trace
        # artifacts; without it, run() makes its own phase-level tracer
        tracer = Tracer(detail=True) if out_dir is not None else None
        result = run(spec, backend=backend, tracer=tracer,
                     device=args.device)
        final = result.trace.fvals[-1] if result.trace.fvals else None
        tta = result.time_to_target
        tag = _result_tag(result)
        # two declared backends can share a tag (same kind+engine, params
        # differing elsewhere); suffix instead of silently clobbering
        n_seen = tags_used.get(tag, 0)
        tags_used[tag] = n_seen + 1
        if n_seen:
            tag = f"{tag}-{n_seen + 1}"
        print(f"[experiments] {spec.name} on {tag}: "
              f"wall={result.wall_s:.2f}s "
              f"final_F={'n/a' if final is None else f'{final:.4g}'} "
              f"tta={'n/a' if tta is None else f'{tta:.4g}'}")
        if out_dir is not None:
            path = out_dir / f"{spec.name}__{tag}.json"
            path.write_text(result.to_json())
            print(f"[experiments] wrote {path}")
            run_name = f"{spec.name}__{tag}"
            tpath = write_chrome_trace(tracer, out_dir / f"{run_name}.trace.json",
                                       run_name=run_name)
            lpath = write_jsonl(tracer, out_dir / f"{run_name}.trace.jsonl")
            print(f"[experiments] wrote {tpath} and {lpath}")
    return 0


def _cmd_trace(args) -> int:
    status = 0
    for i, path in enumerate(args.results):
        if i:
            print()
        try:
            result = json.loads(pathlib.Path(path).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"[experiments] cannot read {path}: {e}")
            status = 2
            continue
        print(render_summary(result))
    return status


def _cmd_list(_args) -> int:
    for reg in (problems, topologies, schedules, stepsizes, backends,
                faultplans):
        print(f"{reg.kind} kinds: {', '.join(reg.names())}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run a spec manifest")
    runp.add_argument("manifest", help="path to an ExperimentSpec JSON")
    runp.add_argument("--backend", default=None,
                      help="only this declared backend kind")
    runp.add_argument("--out", default=None,
                      help="directory for RunResult JSON artifacts")
    runp.add_argument("--device", default=None,
                      help="torch device to run on (default: the CUDA "
                           "card; 'cpu' runs on the CPU)")
    runp.set_defaults(fn=_cmd_run)
    tracep = sub.add_parser("trace",
                            help="summarize saved RunResult JSON artifacts")
    tracep.add_argument("results", nargs="+",
                        help="RunResult JSON file(s) from `run --out`")
    tracep.set_defaults(fn=_cmd_trace)
    listp = sub.add_parser("list", help="print the component registries")
    listp.set_defaults(fn=_cmd_list)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream pager/head closed the pipe mid-summary: not an error
        sys.stderr.close()
        return 0


if __name__ == "__main__":
    sys.exit(main())
