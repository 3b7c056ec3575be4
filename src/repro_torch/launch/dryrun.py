"""Multi-device dry run (twin of ``repro/launch/dryrun.py``).

Traces one rank of every (architecture x input-shape) cell of the
production meshes (single: 16x16 = 256 cards; multi: 2x16x16 = 512) on
the meta device: the rank's step, with its arguments cut to its storage
(``launch/steps.py::rank_args``), runs on tensors with shapes and no
data, through the mesh's collectives made shape-only
(``distributed/sharding.py``). One process, no card: where JAX lowers
and compiles for 256 host devices, the port traces the one rank
(``--rank``, default 0) that SPMD makes every rank alike. Each cell
writes ``experiments/dryrun_torch/<cell>.json``: the rank's argument
bytes and peak estimate, its FLOPs and collective bytes by kind
(``roofline/trace_analysis.py``) and the roofline terms at the H100's
peaks (``roofline/analysis.py``, modelled).

Read path: the path a card would run (the flash kernels in training,
the cascade kernels' read in serving) with each kernel call replaced,
by name, by its plain torch version (``kernels/trace.py``);
``read_path`` records the kernels and how often each was called. A cell
that raises records ``ok: false``, the error, the ROADMAP item it names
(``roadmap_item``) and the traceback's tail, and exits 1; under
``--all`` a cell past ``--timeout`` is killed and records ``ok: false``
and the timeout.

Run one cell:   python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
                    --shape train_4k --mesh single
Run everything: python -m repro_torch.launch.dryrun --all --jobs 4
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: targets whose prefill runs a per-token scan (minutes to trace at 32k)
SLOW = ("recurrentgemma-2b", "rwkv6-1.6b")


def _cell_name(arch, shape, mesh):
    return f"{arch}_{shape}_{mesh}".replace("/", "-")


def _item(err: BaseException):
    """The ROADMAP item an error names ("10d"), or None."""
    m = re.search(r"item (\d+[a-z]?)", str(err))
    return m.group(1) if m else None


def arg_parts(cell, args):
    """A rank's argument bytes of ``cell`` by part: a train cell's params,
    optimizer state and batch; a serving cell's weights (the bundle at
    the rank's storage, an encoder's params), engine state and inputs
    (the prompts, the context)."""
    from repro_torch.core.state import EngineState
    from repro_torch.roofline import trace_analysis as ta
    if cell.kind == "train":
        params, opt, batch = args
        return {"params": ta.storage_bytes(params),
                "opt_state": ta.storage_bytes(opt),
                "batch": ta.storage_bytes(batch)}
    at = next(i for i, a in enumerate(args) if isinstance(a, EngineState))
    return {"params": ta.storage_bytes(args[:at]),
            "state": ta.storage_bytes(args[at]),
            "inputs": ta.storage_bytes(args[at + 1:])}


def trace_cell(cell, mesh, rules=None, fsdp=None):
    """(argument bytes by part, trace counts) of ``cell`` for the rank of
    ``mesh`` (a ``sharding.Mesh``; shape-only or real): its arguments as
    JAX's ``in_shardings`` cut them (``steps.rank_args``), parts by
    :func:`arg_parts`."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_lib
    from repro_torch.roofline import trace_analysis as ta
    rules = dict(cell.rules) if rules is None else rules
    fsdp = cell.fsdp if fsdp is None else fsdp
    with sh.use_sharding(mesh, rules, fsdp=fsdp):
        args = steps_lib.rank_args(cell)
        parts = arg_parts(cell, args)
        counts = ta.trace_counts(cell.fn, *args)
    return parts, counts


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             gamma: int = 16, k_branches: int = 4,
             loss_seq_chunk=None, remat_policy=None,
             tag: str = "", rank: int = 0,
             rules_override: dict = None, fsdp_override=None) -> dict:
    from repro_torch.config.base import shape_by_name
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis as roof

    t0 = time.time()
    multi = mesh_kind == "multi"
    n_chips = 512 if multi else 256
    mesh = make_production_mesh(multi_pod=multi, rank=rank)

    cell = steps_lib.build_cell(arch, shape_name, gamma=gamma,
                                k_branches=k_branches,
                                loss_seq_chunk=loss_seq_chunk,
                                remat_policy=remat_policy)
    if cell is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "long_500k requires sub-quadratic attention",
                "ok": True}
    cfg = cell.cfg
    shape = shape_by_name(shape_name)
    rules = dict(cell.rules)
    if rules_override:
        rules.update(rules_override)
    fsdp = cell.fsdp if fsdp_override is None else fsdp_override
    t_build = time.time() - t0
    parts, counts = trace_cell(cell, mesh, rules, fsdp)
    t_trace = time.time() - t0 - t_build

    arg_bytes = sum(parts.values())
    if cell.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        hbm = roof.analytic_hbm_bytes(cfg, shape, "train", n_chips,
                                      parts["params"],
                                      opt_bytes_per_dev=parts["opt_state"])
    elif cell.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        hbm = roof.analytic_hbm_bytes(cfg, shape, "prefill", n_chips,
                                      parts["params"],
                                      state_bytes_per_dev=parts["state"])
    else:
        gamma_tok = gamma + k_branches * (gamma - 1)
        tokens = shape.global_batch * gamma_tok
        hbm = roof.analytic_hbm_bytes(cfg, shape, "decode", n_chips,
                                      parts["params"],
                                      state_bytes_per_dev=parts["state"],
                                      spec_overhead=3.0)
    link = roof.link_bw(mesh.shape)
    terms = roof.derive_terms(cfg, shape, cell.kind, n_chips, counts, hbm,
                              tokens, link=link)
    temp = counts.pop("temp_peak_bytes")
    kernels = counts.pop("kernels")
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": cell.kind, "ok": True, "chips": n_chips, "rank": rank,
        "tag": tag,
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes_per_dev": int(arg_bytes),
            "argument_parts": {k: int(v) for k, v in parts.items()},
            "temp_bytes_per_dev": int(temp),
            "peak_estimate_gb": round((arg_bytes + temp) / 2 ** 30, 3),
        },
        "counts": counts,
        "read_path": {"attn_impl": cfg.attn_impl if cell.kind != "train"
                      else "kernel",
                      "kernels_traced_plain": kernels},
        "terms": dict(terms.as_dict(), link_bw=link,
                      modelled="H100 SXM peaks (roofline/analysis.py)"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--gamma", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--loss-seq-chunk", type=int, default=None)
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0,
                    help="the mesh rank to trace (row-major coordinates)")
    ap.add_argument("--rules", default=None,
                    help='JSON rules override, e.g. \'{"act_seq": null}\'')
    ap.add_argument("--fsdp", default=None, choices=["on", "off"])
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--timeout", type=float, default=3600,
                    help="seconds a cell of --all may take")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if not args.all:
        assert args.arch and args.shape
        name = _cell_name(args.arch, args.shape, args.mesh)
        if args.tag:
            name += f"_{args.tag}"
        out = out_dir / f"{name}.json"
        try:
            rec = run_cell(args.arch, args.shape, args.mesh,
                           gamma=args.gamma, k_branches=args.k,
                           loss_seq_chunk=args.loss_seq_chunk,
                           remat_policy=args.remat_policy, tag=args.tag,
                           rank=args.rank,
                           rules_override=(json.loads(args.rules)
                                           if args.rules else None),
                           fsdp_override=(None if args.fsdp is None
                                          else args.fsdp == "on"))
        except Exception as e:  # noqa: BLE001 -- recorded, exit 1
            rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                   "ok": False, "error": repr(e)[:2000],
                   "roadmap_item": _item(e),
                   "traceback": traceback.format_exc()[-4000:]}
        out.write_text(json.dumps(rec, indent=2))
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("traceback",)}, indent=2))
        sys.exit(0 if rec.get("ok") else 1)

    # orchestrate all cells as subprocesses (isolation + parallelism)
    from repro_torch.config.registry import ARCH_IDS
    jobs = []
    for mesh_kind in ("single", "multi"):
        for arch in ARCH_IDS:
            for shape in ALL_SHAPES:
                name = _cell_name(arch, shape, mesh_kind)
                out = out_dir / f"{name}.json"
                if out.exists() and not args.force:
                    try:
                        if json.loads(out.read_text()).get("ok"):
                            continue
                    except ValueError:
                        pass
                jobs.append((arch, shape, mesh_kind))
    # the longest first: a recurrent target's prefill runs its per-token
    # scan over 32k tokens, the 1T MoE builds its bundle for minutes
    jobs.sort(key=lambda j: (j[1] != "prefill_32k" or j[0] not in SLOW,
                             "kimi" not in j[0]))

    print(f"{len(jobs)} cells to run", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    running, results = [], []
    while jobs or running:
        while jobs and len(running) < args.jobs:
            arch, shape, mesh_kind = jobs.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                   "--out-dir", str(out_dir)]
            proc = subprocess.Popen(cmd, env=env,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
            running.append((proc, arch, shape, mesh_kind, time.time()))
        time.sleep(0.5)
        still = []
        for proc, arch, shape, mesh_kind, t0 in running:
            if proc.poll() is None:
                if time.time() - t0 > args.timeout:
                    proc.kill()
                    proc.wait()
                    name = _cell_name(arch, shape, mesh_kind)
                    (out_dir / f"{name}.json").write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "ok": False, "roadmap_item": None,
                        "error": f"timed out after {args.timeout:.0f} s"},
                        indent=2))
                    print(f"TIMEOUT {arch} {shape} {mesh_kind}", flush=True)
                    results.append((arch, shape, mesh_kind, False))
                else:
                    still.append((proc, arch, shape, mesh_kind, t0))
                continue
            ok = proc.returncode == 0
            print(f"done {arch} {shape} {mesh_kind} ok={ok} "
                  f"{time.time() - t0:.0f}s", flush=True)
            results.append((arch, shape, mesh_kind, ok))
        running = still
    n_ok = sum(1 for r in results if r[3])
    print(f"\n{n_ok}/{len(results)} newly-run cells ok", flush=True)


if __name__ == "__main__":
    main()
