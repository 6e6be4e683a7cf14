"""CLI for the port's experiment server (`repro.serve`'s, on the card).

    # boot a server on the CUDA card (prints the bound address; --port 0
    # picks a free port); --device cpu serves on the CPU
    PYTHONPATH=src python -m repro_torch.serve serve --port 7411 --workers 2

    # submit manifests to it (streams progress, optionally saves results)
    PYTHONPATH=src python -m repro_torch.serve submit \
        benchmarks/manifests/*.json --port 7411 --backend dense \
        --out results/serve --retries 3

    # observe / stop it
    PYTHONPATH=src python -m repro_torch.serve stats --port 7411
    PYTHONPATH=src python -m repro_torch.serve ping  --port 7411
    PYTHONPATH=src python -m repro_torch.serve shutdown --port 7411

`serve --workers N` runs N supervised worker *processes* (crash restart,
re-enqueue, deadline kills), each with its own CUDA context; `--workers
0` (the default) runs in the server's process. `--deadline-s` and
`--max-queue` bound per-request budget and admission; `--chaos-plan`
loads a seeded `ChaosPlan` JSON for fault drills.

`submit` writes each RunResult as `<out>/<name>__serve-<backend>.json` --
the same artifact shape as `python -m repro_torch.experiments run
--out`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.serve.client import Client, ServeError
from repro_torch.serve.server import ExperimentServer


def _cmd_serve(args) -> int:
    chaos = None
    if args.chaos_plan:
        from repro_torch.serve.chaos import ChaosPlan
        chaos = ChaosPlan.from_dict(
            json.loads(pathlib.Path(args.chaos_plan).read_text()))
    server = ExperimentServer(host=args.host, port=args.port,
                              workers=args.threads,
                              max_width=args.max_lane,
                              max_wait_s=args.max_wait,
                              cache_entries=args.cache_entries,
                              packing=not args.no_packing,
                              processes=args.workers,
                              deadline_s=args.deadline_s,
                              max_queue=args.max_queue,
                              chaos=chaos, device=args.device)
    host, port = server.start()
    mode = (f"workers={args.workers} procs" if args.workers
            else f"in-process threads={args.threads}")
    print(f"[serve] listening on {host}:{port} on {server.device} "
          f"({mode} max_lane={args.max_lane} max_wait={args.max_wait}s "
          f"deadline_s={args.deadline_s} max_queue={args.max_queue})",
          flush=True)
    if args.port_file:
        pathlib.Path(args.port_file).write_text(str(port))
    try:
        # serve until the TCP loop exits (a client `shutdown` op, which
        # calls server.close() and stops serve_forever)
        while server._tcp_thread is not None and \
                server._tcp_thread.is_alive():
            server._tcp_thread.join(timeout=1.0)
    except KeyboardInterrupt:
        print("[serve] interrupted; draining", flush=True)
    finally:
        server.close()
    print("[serve] stopped", flush=True)
    return 0


def _cmd_submit(args) -> int:
    out_dir = pathlib.Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    status = 0
    with Client(args.host, args.port, timeout=args.timeout,
                retries=args.retries) as client:
        for path in args.manifests:
            spec = ExperimentSpec.from_file(path)
            try:
                result = client.run(spec, backend=args.backend,
                                    deadline_s=args.deadline_s)
            except ServeError as e:
                print(f"[serve] {spec.name}: ERROR {e}")
                status = 1
                continue
            c = (result.metrics.counters if result.metrics else {}) or {}
            hit = ("hit" if c.get("cache_hit")
                   else "miss" if c.get("cache_miss") else "n/a")
            final = result.trace.fvals[-1] if result.trace.fvals else None
            print(f"[serve] {spec.name} on {result.backend.kind}: "
                  f"wall={result.wall_s:.3f}s cache={hit} "
                  f"lane_width={int(c.get('lane_width', 1))} "
                  f"queue_wait={c.get('queue_wait_s', 0.0):.3f}s "
                  f"final_F={'n/a' if final is None else f'{final:.4g}'}")
            if out_dir is not None:
                tag = args.backend or result.backend.kind
                p = out_dir / f"{spec.name}__serve-{tag}.json"
                p.write_text(result.to_json())
                print(f"[serve] wrote {p}")
    return status


def _cmd_stats(args) -> int:
    with Client(args.host, args.port, timeout=args.timeout) as client:
        print(json.dumps(client.stats(), indent=2, sort_keys=True))
    return 0


def _cmd_ping(args) -> int:
    with Client(args.host, args.port, timeout=args.timeout) as client:
        ok = client.ping()
    print(f"[serve] {args.host}:{args.port} "
          f"{'alive' if ok else 'NOT RESPONDING'}")
    return 0 if ok else 1


def _cmd_shutdown(args) -> int:
    with Client(args.host, args.port, timeout=args.timeout) as client:
        client.shutdown()
    print(f"[serve] asked {args.host}:{args.port} to shut down")
    return 0


def main(argv=None) -> int:
    # --host/--port/--timeout live on a parent parser attached to every
    # subcommand, so they are accepted in the natural position AFTER the
    # subcommand name (`... serve --port 0`, `... ping --port 7411`)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--host", default="127.0.0.1")
    common.add_argument("--port", type=int, default=7411)
    common.add_argument("--timeout", type=float, default=600.0,
                        help="client socket timeout (seconds)")

    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    servep = sub.add_parser("serve", help="boot a server (blocks)",
                            parents=[common])
    servep.add_argument("--workers", type=int, default=0,
                        help="supervised worker PROCESSES; 0 = run "
                             "in-process")
    servep.add_argument("--device", default=None,
                        help="where runs happen: the CUDA card by default "
                             "(fails without one); 'cpu' for the CPU")
    servep.add_argument("--threads", type=int, default=2,
                        help="in-process executor width (pool mode uses "
                             "these threads only for bookkeeping)")
    servep.add_argument("--deadline-s", type=float, default=None,
                        help="default per-request budget; expired work "
                             "is shed, not run")
    servep.add_argument("--max-queue", type=int, default=0,
                        help="bounded admission queue (0 = unbounded); "
                             "over-limit submits get a structured "
                             "overloaded error + retry-after hint")
    servep.add_argument("--chaos-plan", default=None,
                        help="path to a ChaosPlan JSON (fault drills)")
    servep.add_argument("--max-lane", type=int, default=4,
                        help="lane packer max width")
    servep.add_argument("--max-wait", type=float, default=0.05,
                        help="lane packer max wait (seconds)")
    servep.add_argument("--cache-entries", type=int, default=32)
    servep.add_argument("--no-packing", action="store_true")
    servep.add_argument("--port-file", default=None,
                        help="write the bound port here (for port 0)")
    servep.set_defaults(fn=_cmd_serve)

    submitp = sub.add_parser("submit", help="run manifests via a server",
                             parents=[common])
    submitp.add_argument("manifests", nargs="+",
                         help="ExperimentSpec JSON file(s)")
    submitp.add_argument("--backend", default=None,
                         help="backend kind override (default: the "
                              "manifest's first declared backend)")
    submitp.add_argument("--out", default=None,
                         help="directory for RunResult JSON artifacts")
    submitp.add_argument("--retries", type=int, default=0,
                         help="client retries with jittered backoff + "
                              "auto idempotency keys")
    submitp.add_argument("--deadline-s", type=float, default=None,
                         help="per-request deadline propagated "
                              "server-side")
    submitp.set_defaults(fn=_cmd_submit)

    sub.add_parser("stats", help="print server stats",
                   parents=[common]).set_defaults(fn=_cmd_stats)
    sub.add_parser("ping", help="liveness check",
                   parents=[common]).set_defaults(fn=_cmd_ping)
    sub.add_parser("shutdown", help="stop a server",
                   parents=[common]).set_defaults(fn=_cmd_shutdown)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
