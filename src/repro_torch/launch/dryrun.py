"""Multi-pod dry run of the port: one rank of a fake 256- or 512-rank world.

Port of ``repro/launch/dryrun.py``.  For every (architecture x shape x
mesh) cell the JAX package lowers and compiles the step on 512 virtual
host devices.  The port runs rank 0's program on fake tensors
(``FakeTensorMode``: shapes, no memory, no launch) in a fake world of 256
(``single``: the (16, 16) ``("data", "model")`` mesh) or 512 ranks
(``multi``: (2, 16, 16) with ``pod``), made in this process on the
``fake`` backend, whose collectives return at once; ``host`` is the
(1, 1) mesh of a one-rank world, as on one card.  It records into
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``:

- ``params``, ``active_params`` and the step's counts;
- the structural FLOPs a rank (``analysis.counts``: aten matmuls and the
  kernels' FLOP formulas) and globally (x ranks);
- memory: ``MemTracker``'s peak by category and the state's bytes (this
  rank's shards, ``launch/specs.py``);
- the collectives by type (the recorded run's), ``reconcile`` (recorded
  vs the declared ``gspmd`` entries, ``analysis.reconcile``), ``roofline``
  (predictions from the H100's data-sheet constants, never times) and
  ``model_flops``, ``useful_flop_ratio``;
- ``contracts``: the sharded arm on the cell's mesh; ``calibration``.

The JAX artifact's ``cost_analysis``, ``hlo_bytes`` and
``roofline_raw_hlo`` have no counterpart: nothing is compiled, so there is
no XLA cost analysis or HLO.  Like the port's train CLI the step runs with
``use_kernels=True`` (``--opt use_kernels=false`` for the plain path):
the kernels' entries take their shape functions and count their
formulas.  ``--opt fsdp=true`` runs the ZeRO-3 step (the params at
their ZeRO-1 slices, ``train_step.state_placements``) in train cells and
the same placements in prefill and decode cells, as the JAX package's
``state_specs`` places them.

Usage:
    python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k \
        --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Any, Dict, Optional

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
# the world of each mesh kind
WORLDS = {"single": 256, "multi": 512, "host": 1}
# --opt keys read by the step or the cell's shape, not the config
STEP_FLAGS = ("planner_loss", "microbatches", "global_batch", "seq_len")


def _mesh(kind: str):
    from .mesh import make_auto_mesh, make_production_mesh
    if kind == "host":
        return make_auto_mesh((1, 1), ("data", "model"), "cpu")
    return make_production_mesh(multi_pod=(kind == "multi"), device="cpu")


def _peak_by_category(snapshot) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for per_dev in snapshot.values():
        for k, v in per_dev.items():
            name = str(getattr(k, "value", k))
            out[name] = out.get(name, 0) + int(v)
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             *, opt_flags: Optional[Dict[str, Any]] = None,
             tag: str = "", calibrated: Optional[str] = None,
             overlap: float = 1.0, config=None, mesh_shape=None,
             rank: int = 0) -> Dict[str, Any]:
    """Run one cell on rank ``rank`` of a fake world; returns the artifact
    dict.  ``config`` runs that ``ModelConfig`` instead of the registry's
    (as given: kernels on only if it says so), and ``mesh_shape`` a
    ``(data, model)`` or ``(pod, data, model)`` mesh of that many ranks
    instead of ``mesh_kind``'s: the tests' small cells.

    ``calibrated`` points at a ``repro_torch.calibrate`` store (``True``:
    the default root): when a calibration loads, the roofline's collective
    term is charged at its fitted channel bandwidth instead of the data
    sheet's link rate.  ``overlap`` is the achievable compute-collective
    overlap of the overlap-adjusted bound (``roofline_terms``)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..analysis.contracts import sharded_contract_checks
    from ..analysis.counts import (FAKE_DEVICE, fake_mode, fake_world,
                                   trace_counts)
    from ..analysis.reconcile import reconcile_cell, stats_from_trace
    from ..analysis.roofline import roofline_terms
    from ..configs.registry import SHAPES, get_config
    from ..models.model import Model
    from ..parallel.collective_planner import train_collective_schedule
    from ..parallel.sharding import dp_size
    from ..train.optimizer import OptConfig
    from ..train.train_step import make_train_step
    from . import specs as S

    opt_flags = dict(opt_flags or {})
    cfg = config if config is not None else get_config(arch).with_(
        use_kernels=True)
    for k, v in opt_flags.items():
        if k not in STEP_FLAGS:
            cfg = cfg.with_(**{k: v})
    shape = SHAPES[shape_name]
    shape = replace(shape, **{k: int(opt_flags[k]) for k in
                              ("global_batch", "seq_len") if k in opt_flags})
    micro = int(opt_flags.get("microbatches", 1))
    planner = bool(opt_flags.get("planner_loss", False))
    model = Model(cfg)
    dev = FAKE_DEVICE
    t0 = time.time()
    devices = WORLDS[mesh_kind]
    if mesh_shape is not None:
        devices = 1
        for n in mesh_shape:
            devices *= int(n)
    with fake_world(devices, rank):
        if mesh_shape is None:
            mesh = _mesh(mesh_kind)
        else:
            from .mesh import make_auto_mesh
            axes = ("data", "model") if len(mesh_shape) == 2 else (
                "pod", "data", "model")
            mesh = make_auto_mesh(tuple(mesh_shape), axes, "cpu")
        rec: Dict[str, Any] = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
            "rank": rank,
            "kind": shape.kind, "devices": devices,
            "mesh_shape": list(mesh.shape),
            "params": model.n_params(), "active_params": cfg.n_active_params(),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "use_kernels": cfg.use_kernels, "fake_device": dev,
        }
        out, cache = [], None
        mt = MemTracker()
        with fake_mode():
            if shape.kind == "train":
                state, _ = S.state_specs(model, mesh, device=dev)
                batch = S.batch_specs(cfg, shape, mesh, device=dev)
                step = make_train_step(model, OptConfig(), mesh,
                                       microbatches=micro,
                                       use_planner_loss=planner)

                def fn():
                    out.append(step(state, batch)[0])
            elif shape.kind == "prefill":
                state, _ = S.state_specs(model, mesh, with_opt=False,
                                         device=dev)
                batch = S.batch_specs(cfg, shape, mesh, with_labels=False,
                                      local=True, device=dev)

                def fn():
                    out.append(model.prefill(state, batch, shape.seq_len,
                                             mesh))
            else:  # decode
                state, _ = S.state_specs(model, mesh, with_opt=False,
                                         device=dev)
                cache, _ = S.cache_specs(model, shape, mesh, device=dev)
                batch = S.batch_specs(cfg, shape, mesh, with_labels=False,
                                      local=True, device=dev)

                def fn():
                    out.append(model.decode(state, cache, batch["tokens"],
                                            mesh, cache_len=shape.seq_len))
            state_bytes = S.tree_bytes(state)
            arg_bytes = state_bytes + S.tree_bytes(batch) + \
                S.tree_bytes(cache)
            with mt:
                trace = trace_counts(fn)
        out_bytes = S.tree_bytes(out)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["records"] = [list(r) for r in trace.records]
        rec["recompute_records"] = [list(r) for r in trace.recompute]
        rec["step_counts"] = {"records": len(trace.records),
                              "recompute_records": len(trace.recompute),
                              "microbatches": micro,
                              "planner_loss": planner}
        rec["structural_flops_per_device"] = trace.flops
        rec["structural_flops_global"] = trace.flops * devices
        if trace.findings:
            rec["trace_findings"] = list(trace.findings)
        peak = _peak_by_category(mt.get_tracker_snapshot("peak"))
        temps = max(0, peak.get("Total", 0) - arg_bytes)
        rec["memory"] = {"state_bytes": state_bytes,
                         "argument_bytes": arg_bytes,
                         "output_bytes": out_bytes,
                         "peak_by_category": peak,
                         "temp_bytes": temps}
        stats = stats_from_trace(trace)
        rec["collectives"] = stats.to_dict()
        rec["recompute_collectives"] = len(trace.recompute)
        schedule = None
        if shape.kind == "train":
            try:
                schedule = train_collective_schedule(
                    cfg, mesh, shape.global_batch, shape.seq_len,
                    microbatches=micro, planner_loss=planner)
            except Exception as e:  # noqa: BLE001 - a declaration gap
                rec["schedule_error"] = repr(e)
        recon = reconcile_cell(trace, schedule=schedule,
                               shards=S.model_shard_bytes(model, mesh))
        rec["reconcile"] = recon.to_dict()
        # one pass over the arguments, the outputs and the temporaries
        mem_traffic = arg_bytes + out_bytes + temps
        wire_pd = recon.total_reconciled_wire
        rec["mem_traffic_per_device"] = mem_traffic
        rec["collective_wire_per_device"] = wire_pd
        rec["collective_wire_recorded_per_device"] = stats.total_wire_bytes
        link_bw = None
        if calibrated:
            from ..calibrate.persist import calibration_path, load_calibration
            cal_path = (calibration_path() if calibrated is True
                        else calibration_path(calibrated))
            cal = load_calibration(cal_path)
            if cal is not None:
                link_bw = cal.params.channel_bandwidth
                rec["calibration"] = {
                    "path": str(cal_path),
                    "backend": cal.provenance.get("backend"),
                    "channel_bandwidth": link_bw,
                    "median_rel_err": cal.median_rel_err}
            else:
                rec["calibration"] = {"path": str(cal_path), "loaded": False}
        rec["roofline"] = roofline_terms(trace.flops, mem_traffic, wire_pd,
                                         link_bw=link_bw, overlap=overlap)
        rec["roofline_note"] = ("predictions from the H100's data-sheet "
                                "constants (analysis/roofline.py), not times")
        if shape.kind == "train":
            tokens, factor = shape.seq_len * shape.global_batch, 6.0
        elif shape.kind == "prefill":
            tokens, factor = shape.seq_len * shape.global_batch, 2.0
        else:
            tokens, factor = shape.global_batch, 2.0
        model_flops = factor * cfg.n_active_params() * tokens
        rec["model_flops_global"] = model_flops
        rec["model_flops_per_device"] = model_flops / devices
        if trace.flops:
            rec["useful_flop_ratio"] = rec["model_flops_per_device"] / \
                trace.flops
        # the sharded softmax path on this cell's mesh against the
        # planner's declaration: the numbers above are only trustworthy if
        # the cost model and the program agree on the wire
        try:
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            dp, p_model = dp_size(mesh), int(sizes.get("model", 1))
            cchecks = sharded_contract_checks(
                mesh, batch=2 * dp, seq=16, d_model=64,
                vocab_p=128 * p_model)
            rec["contracts"] = {
                "checked": len(cchecks),
                "failures": [c.to_dict() for c in cchecks if not c.ok],
                "ok": all(c.ok for c in cchecks)}
        except Exception as e:  # noqa: BLE001 - the verdict is recorded
            rec["contracts"] = {"error": repr(e), "ok": False}
    return rec


def artifact_path(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(ARTIFACT_DIR,
                        f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def parse_opt(text: str) -> Dict[str, Any]:
    """``k=v,k=v`` -> {k: bool | int | float | str}."""
    opt_flags: Dict[str, Any] = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        if v.lower() in ("true", "false"):
            opt_flags[k] = v.lower() == "true"
        elif v.lstrip("-").isdigit():
            opt_flags[k] = int(v)
        else:
            try:
                opt_flags[k] = float(v)
            except ValueError:
                opt_flags[k] = v
    return opt_flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--calibrated", nargs="?", const=True, default=None,
                    metavar="STORE",
                    help="charge the roofline's collective term at the "
                         "calibrated channel bandwidth from STORE (default: "
                         "the plan-store root) instead of the data sheet's "
                         "link rate")
    ap.add_argument("--overlap", type=float, default=1.0,
                    help="achievable compute-collective overlap for the "
                         "overlap-adjusted roofline bound (default 1.0; "
                         "the serial bound is always reported too)")
    ap.add_argument("--opt", default="",
                    help="comma k=v model-config overrides, and the step's "
                         "planner_loss, microbatches, global_batch, seq_len")
    ap.add_argument("--out", default=None,
                    help="write the artifact here (one cell) instead of "
                         "artifacts/dryrun_torch/")
    args = ap.parse_args(argv)
    if not 0.0 <= args.overlap <= 1.0:
        ap.error("--overlap must lie in [0, 1]")
    opt_flags = parse_opt(args.opt)

    from ..configs.registry import all_cells
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for arch, shape in cells:
        for mk in meshes:
            path = args.out or artifact_path(arch, shape, mk, args.tag)
            if args.skip_existing and os.path.exists(path):
                print(f"skip {path}")
                continue
            try:
                rec = run_cell(arch, shape, mk, opt_flags=opt_flags,
                               tag=args.tag, calibrated=args.calibrated,
                               overlap=args.overlap)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec["roofline"]
                c = rec.get("contracts", {})
                verdict = ("contracts=ok" if c.get("ok")
                           else f"contracts=FAIL({len(c.get('failures', []))}"
                                f"{' ' + c['error'] if 'error' in c else ''})")
                nrf = len(rec.get("reconcile", {}).get("findings", []))
                verdict += (" recon=clean" if nrf == 0
                            else f" recon={nrf} findings")
                print(f"OK  {arch:22s} {shape:12s} {mk:6s} "
                      f"trace={rec['trace_s']:7.1f}s "
                      f"flops/rank={rec['structural_flops_per_device']:.4g} "
                      f"predicted t=({r['t_compute_s']:.3e},"
                      f"{r['t_memory_s']:.3e},{r['t_collective_s']:.3e})s "
                      f"bottleneck={r['bottleneck']} {verdict} -> {path}",
                      flush=True)
            except Exception as e:  # noqa: BLE001 - the sweep goes on
                failures.append((arch, shape, mk, repr(e)))
                print(f"FAIL {arch} {shape} {mk}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
