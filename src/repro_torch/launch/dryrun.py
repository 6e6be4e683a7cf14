"""Multi-pod dry-run, the port of `repro.launch.dryrun`: every (architecture
x input-shape x mesh) cell's step arguments built on the production mesh's
layout, and their per-device bytes reckoned from the logical sharding
rules.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]

The reference lowers and compiles each cell for 512 placeholder devices
and records XLA's memory and cost analyses. Torch compiles nothing ahead
of a run, so the port builds the same arguments as meta tensors beside
their specs (`launch/specs.py`) and reckons:

  * `memory.argument_size_in_bytes`: each argument leaf's per-device shard
    bytes under its spec, summed over the leaves the step reads (found by
    running the step on the meta tensors: jit leaves an unread argument
    out, such as the prefill batch's `labels`);
  * `output_size_in_bytes` and `alias_size_in_bytes` from the same sums
    (outputs under the specs of the arguments they update, the metrics
    and logits as the port lays them; donation aliases the training state
    and the decode cache, as in the reference);
  * `temp_size_in_bytes` and `generated_code_size_in_bytes`: null, since
    torch has no compile-time memory analysis, so `bytes_per_device` is
    arguments plus unaliased outputs, without temporaries;
  * `cost.flops`: one pod's step counted by `FlopCounterMode` on the meta
    tensors (matmuls and convolutions; XLA also counts elementwise work),
    divided over the devices that run it;
  * `collectives`: only the consensus pod mix the port can reckon, under
    its own name `pod_mix`: the fused step's float32 mix of each device's
    parameter shard, one all-reduce on the complete graph (k exchanges on
    a k-regular one), bytes per device per comm round. The FSDP and tensor
    parallel collectives come when the data and model axes execute;
    `hlo_collective_op_counts` is null (no HLO).

`lower_s` is the seconds spent building the arguments and specs, and
`compile_s` the seconds of the meta run. Writes one JSON per cell under
results/dryrun_torch/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Any

import torch
import torch.utils._pytree as _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.graphs import complete_graph
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import registry
from repro_torch.optim import adamw, cosine_lr

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")

PyTree = Any


class _Reads(TorchDispatchMode):
    """Records which of the given tensors an op takes as an input."""

    def __init__(self, tensors):
        super().__init__()
        self.ids = {id(t) for t in tensors}
        self.read: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in _pytree.tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor) and id(a) in self.ids:
                self.read.add(id(a))
        return func(*args, **kwargs)


def _leaves(tree: PyTree) -> list:
    return [t for t in _pytree.tree_leaves(tree) if t is not None]


def _specs(specs: PyTree) -> list:
    return [s for s in sp.spec_leaves(specs) if s is not None]


def _meta_run(step, args: tuple) -> tuple[float, set[int]]:
    """(flops, ids of the argument leaves read) of one call of `step` on
    meta tensors."""
    reads = _Reads(_leaves(args))
    with FlopCounterMode(display=False) as counter, reads:
        step(*args)
    return float(counter.get_total_flops()), reads.read


def pod_mix_bytes(param_shard_bytes_f32: int, graph) -> int:
    """Bytes a device ships per comm round in the pod mix: one all-reduce
    of its parameter shard on the complete graph, k exchanges of it on a
    k-regular graph."""
    rounds = 1 if graph.name == "complete" else graph.degree
    return rounds * param_shard_bytes_f32


def _cell_args(cfg, cell: ShapeCell, mesh, multi_pod: bool,
               optimizer) -> dict:
    """A cell's step, its arguments on the meta device beside their specs
    (pod-stacked on the multi-pod mesh for training), the arguments of one
    pod's call of the step, and the devices that call runs on."""
    sizes = mesh_shape(mesh)
    moe_groups = sizes["data"] if cfg.moe_experts else 1
    params, pspecs = sp.param_specs(cfg, mesh)
    out = {"params": params, "pspecs": pspecs, "run_devices": mesh.size}
    if cell.kind == "train":
        state, sspecs = sp.opt_state_specs(optimizer, params, pspecs)
        batch, bspecs = sp.batch_specs(cfg, cell, mesh, consensus=multi_pod)
        out["step"] = make_train_step(cfg, optimizer, moe_groups=moe_groups,
                                      microbatches=cfg.train_microbatches)
        if multi_pod:  # consensus: one pod's step on its slice
            n_pods = sizes["pod"]
            out["pod_args"] = (params, state,
                               {k: v[0] for k, v in batch.items()})
            params, pspecs = sp.pod_stack_specs(params, pspecs, n_pods)
            state, sspecs = sp.pod_stack_specs(state, sspecs, n_pods)
            out["run_devices"] = mesh.size // n_pods
        out["args"] = (params, state, batch)
        out["specs"] = (pspecs, sspecs, bspecs)
    elif cell.kind == "prefill":
        batch, bspecs = sp.batch_specs(cfg, cell, mesh, consensus=False)
        out["step"] = make_prefill_step(cfg, moe_groups=moe_groups)
        out["args"], out["specs"] = (params, batch), (pspecs, bspecs)
    else:  # decode
        cache, cspecs = sp.cache_specs(cfg, cell, mesh)
        toks, tspecs = sp.decode_token_specs(cell, mesh)
        out["step"] = make_serve_step(cfg, moe_groups=1)
        out["args"] = (params, cache, toks["tokens"], toks["pos"])
        out["specs"] = (pspecs, cspecs, tspecs["tokens"], tspecs["pos"])
    out.setdefault("pod_args", out["args"])
    return out


def _flops_and_reads(cfg, cell: ShapeCell, mesh, multi_pod: bool,
                     optimizer) -> tuple[float, list]:
    """(flops of one pod's step, which of its argument leaves it reads, by
    position). The superblock repetitions are identical work, so the step
    runs on meta at 1 and 2 repetitions and the count extends linearly to
    `cfg.n_super`, exactly; the leaves read are the same at any depth."""
    runs = []
    for n in ((1, 2) if cfg.n_super > 2 else (cfg.n_super,)):
        part = _cell_args(dataclasses.replace(cfg, n_super=n), cell, mesh,
                          multi_pod, optimizer)
        flops, read = _meta_run(part["step"], part["pod_args"])
        runs.append((flops, [[id(t) in read for t in _leaves(a)]
                             for a in part["pod_args"]]))
    flops = runs[0][0]
    if len(runs) == 2:
        flops += (cfg.n_super - 1) * (runs[1][0] - runs[0][0])
    return flops, runs[0][1]


def dryrun_cell(arch: str, cell: ShapeCell, multi_pod: bool,
                *, save: bool = True, donate: bool = True,
                verbose: bool = True, cfg_override=None) -> dict:
    """Build one (arch, shape, mesh) cell on meta tensors and reckon its
    per-device bytes; return the record."""
    cfg = cfg_override or registry.get_config(arch, "full")
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    sizes = mesh_shape(mesh)
    rec: dict[str, Any] = {"arch": arch, "shape": cell.name,
                           "mesh": mesh_name, "kind": cell.kind,
                           "seq_len": cell.seq_len,
                           "global_batch": cell.global_batch}
    t0 = time.time()
    optimizer = adamw(cosine_lr(3e-4, 10000),
                      moment_dtype=(torch.bfloat16 if cfg.opt_moments_bf16
                                    else torch.float32))
    built = _cell_args(cfg, cell, mesh, multi_pod, optimizer)
    args, specs = built["args"], [_specs(s) for s in built["specs"]]
    leaves = [_leaves(a) for a in args]
    rec["lower_s"] = round(time.time() - t0, 1)

    t1 = time.time()
    flops, read = _flops_and_reads(cfg, cell, mesh, multi_pod, optimizer)
    rec["compile_s"] = round(time.time() - t1, 1)

    def total(i, only_read=False):
        return sum(sp.shard_bytes(t, s, mesh) for t, s, r in
                   zip(leaves[i], specs[i], read[i]) if r or not only_read)

    arg_bytes = sum(total(i, only_read=True) for i in range(len(args)))
    collectives: dict[str, float] = {}
    if cell.kind == "train":
        state_bytes = total(0) + total(1)
        n_metrics = sizes["pod"] if multi_pod else 1
        out_bytes = state_bytes + 2 * 4 * n_metrics  # loss, grad_norm
        alias_bytes = state_bytes if donate else 0
        if multi_pod:
            # the fused step's float32 mix of each device's parameter shard
            shard_f32 = sum(sp.shard_bytes(t, s, mesh) // t.element_size()
                            * 4 for t, s in zip(_leaves(built["params"]),
                                                _specs(built["pspecs"])))
            collectives["pod_mix"] = float(
                pod_mix_bytes(shard_f32, complete_graph(sizes["pod"])))
    elif cell.kind == "prefill":
        # the last position's logits (B, V), B as the batch is laid out
        B = cell.global_batch
        logits = torch.empty((B, cfg.vocab_size), dtype=cfg.dtype,
                             device="meta")
        out_bytes = sp.shard_bytes(logits, built["specs"][1]["tokens"][:1],
                                   mesh)
        alias_bytes = 0
    else:
        # logits (B, 1, V), B as the tokens are laid out, and the cache
        B = cell.global_batch
        logits = torch.empty((B, 1, cfg.vocab_size), dtype=cfg.dtype,
                             device="meta")
        cache_bytes = total(1)
        out_bytes = cache_bytes + sp.shard_bytes(
            logits, built["specs"][2][:1], mesh)
        alias_bytes = cache_bytes if donate else 0
    rec["memory"] = {"argument_size_in_bytes": float(arg_bytes),
                     "output_size_in_bytes": float(out_bytes),
                     "temp_size_in_bytes": None,
                     "generated_code_size_in_bytes": None,
                     "alias_size_in_bytes": float(alias_bytes)}
    rec["cost"] = {"flops": flops / built["run_devices"]}
    rec["collectives"] = collectives
    rec["hlo_collective_op_counts"] = None
    rec["bytes_per_device"] = float(arg_bytes
                                    + max(out_bytes - alias_bytes, 0))
    rec["devices"] = mesh.size
    if verbose:
        print(f"[dryrun] {arch} {cell.name} {mesh_name}: "
              f"build {rec['lower_s']}s meta run {rec['compile_s']}s  "
              f"mem/dev {rec['bytes_per_device'] / 2 ** 30:.2f} GiB "
              f"(no temporaries)  flops {rec['cost']['flops']:.3g}",
              flush=True)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        fname = RESULTS / f"{arch}__{cell.name}__{mesh_name}.json"
        fname.write_text(json.dumps(rec, indent=1))
    return rec


def dryrun_cell_with_cfg(arch: str, cfg, cell: ShapeCell, multi_pod: bool,
                         *, save: bool = False, verbose: bool = False) -> dict:
    """Probe variant: `cell` under an explicit (modified) config."""
    return dryrun_cell(arch, cell, multi_pod, save=save, verbose=verbose,
                       cfg_override=cfg)


def iter_cells(multi_pod_only=False, arch_filter=None, shape_filter=None):
    for arch in registry.ARCH_IDS:
        if arch_filter and arch != arch_filter:
            continue
        for cell in registry.get_shapes(arch).values():
            if shape_filter and cell.name != shape_filter:
                continue
            if cell.skip:
                yield arch, cell, None
                continue
            meshes = [True] if multi_pod_only else [False, True]
            for mp in meshes:
                yield arch, cell, mp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    failures = []
    for arch, cell, mp in iter_cells(args.multi_pod_only, args.arch,
                                     args.shape):
        if mp is None:
            print(f"[dryrun] SKIP {arch} {cell.name}: {cell.skip}")
            continue
        if args.single_pod_only and mp:
            continue
        try:
            dryrun_cell(arch, cell, mp, save=not args.no_save)
        except Exception:  # noqa: BLE001 -- reported, then counted
            failures.append((arch, cell.name, mp))
            traceback.print_exc()
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells built OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
