"""Roofline report (twin of ``repro/roofline/report.py``): reads the dry
run's ``experiments/dryrun_torch/*.json`` (``launch/dryrun.py``) and
renders its tables. The terms are modelled at the H100 SXM's peaks
(``roofline/analysis.py``), not measured.

    python -m repro_torch.roofline.report [DIR]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

DRYRUN_DIR = (Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ARCHS = ("qwen2.5-3b", "internlm2-20b", "gemma2-2b", "stablelm-3b",
         "recurrentgemma-2b", "kimi-k2-1t-a32b", "grok-1-314b",
         "llama-3.2-vision-11b", "whisper-medium", "rwkv6-1.6b")
#: a card's memory, for the peak estimate's column
CARD_GB = 80.0


def load_cells(mesh: str = "single", tag: str = "",
               root: Optional[Path] = None) -> Dict:
    root = DRYRUN_DIR if root is None else Path(root)
    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            name = f"{arch}_{shape}_{mesh}" + (f"_{tag}" if tag else "")
            p = root / f"{name}.json"
            if p.exists():
                out[(arch, shape)] = json.loads(p.read_text())
    return out


def _fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _failed(c) -> str:
    item = c.get("roadmap_item")
    return f"refused ({item})" if item else "FAILED"


def roofline_table(mesh: str = "single", tag: str = "",
                   root: Optional[Path] = None) -> str:
    cells = load_cells(mesh, tag, root)
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "useful (6ND/traced) | roofline frac | peak GB/rank |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            c = cells.get((arch, shape))
            if c is None:
                lines.append(f"| {arch} | {shape} | (missing) | | | | | | |")
                continue
            if c.get("skipped"):
                lines.append(f"| {arch} | {shape} | skipped "
                             f"(quadratic attn @500k) | | | | | | |")
                continue
            if not c.get("ok"):
                lines.append(f"| {arch} | {shape} | {_failed(c)} "
                             "| | | | | | |")
                continue
            t = c["terms"]
            lines.append(
                f"| {arch} | {shape} | {_fmt_s(t['compute_s'])} | "
                f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
                f"**{t['dominant']}** | {t['useful_ratio']:.2f} | "
                f"{t['roofline_fraction']:.3f} | "
                f"{c['memory']['peak_estimate_gb']:.1f} |")
    return "\n".join(lines)


def dryrun_table(mesh: str, root: Optional[Path] = None) -> str:
    cells = load_cells(mesh, root=root)
    n_ok = sum(1 for c in cells.values() if c.get("ok"))
    n_skip = sum(1 for c in cells.values() if c.get("skipped"))
    lines = [
        f"mesh={mesh}: {n_ok}/{len(cells)} cells ok "
        f"({n_skip} skipped by design)",
        "",
        "| arch | shape | kind | trace_s | args GB/rank | peak GB/rank "
        f"(of {CARD_GB:.0f}) | traced GF/rank | coll MB/rank |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), c in sorted(cells.items()):
        if c.get("skipped"):
            lines.append(f"| {arch} | {shape} | skip | - | - | - | - | - |")
            continue
        if not c.get("ok"):
            lines.append(f"| {arch} | {shape} | {_failed(c)} | - | - | - | "
                         "- | - |")
            continue
        m = c["memory"]
        lines.append(
            f"| {arch} | {shape} | {c['kind']} | {c.get('trace_s', 0)} | "
            f"{m['argument_bytes_per_dev'] / 2**30:.2f} | "
            f"{m['peak_estimate_gb']:.2f} | "
            f"{c['counts']['flops'] / 1e9:.0f} | "
            f"{c['counts']['coll_bytes'] / 2**20:.0f} |")
    return "\n".join(lines)


def _brief(c) -> str:
    """A cell's status for :func:`summary_table`."""
    if c is None:
        return "(missing) | | | |"
    if c.get("skipped"):
        return "skipped | | | |"
    if not c.get("ok"):
        item = c.get("roadmap_item")
        what = (f"refused ({item})" if item else
                "timed out" if "timed out" in c.get("error", "") else
                "FAILED")
        return f"{what} | | | |"
    m, t = c["memory"], c["terms"]
    return (f"ok | {m['argument_bytes_per_dev'] / 2**30:.2f} | "
            f"{m['peak_estimate_gb']:.1f}"
            f"{' (over)' if m['peak_estimate_gb'] > CARD_GB else ''} | "
            f"{t['dominant']} | {t['roofline_fraction']:.3f}")


def summary_table(root: Optional[Path] = None) -> str:
    """Every cell on both meshes: ok or the ROADMAP item that refuses it,
    argument GiB a rank, the peak estimate in GB (``(over)`` past a
    card's CARD_GB), the dominant term and the roofline fraction
    (modelled at the H100 SXM's peaks)."""
    single, multi = load_cells("single", root=root), load_cells("multi",
                                                                root=root)
    head = "status | args GiB | peak GB | dominant | roofline frac"
    lines = [f"| arch | shape | single: {head} | multi: {head} |",
             "|---|---|" + "---|" * 10]
    for arch in ARCHS:
        for shape in SHAPES:
            lines.append(f"| {arch} | {shape} | "
                         f"{_brief(single.get((arch, shape)))} | "
                         f"{_brief(multi.get((arch, shape)))} |")
    return "\n".join(lines)


def serving_parts_table(mesh: str = "single",
                        root: Optional[Path] = None) -> str:
    """The serving cells' argument bytes a rank by part (the weights, the
    engine state, the inputs; GB) and the all-gather bytes a rank sends
    a step (GB): what a rank holds and gathers at JAX's layouts."""
    lines = [f"| arch | shape ({mesh}) | params GB | state GB | inputs GB "
             "| all-gather GB | peak GB |", "|---|---|---|---|---|---|---|"]
    for (arch, shape), c in sorted(load_cells(mesh, root=root).items()):
        if not c.get("ok") or c.get("skipped") or c.get("kind") == "train":
            continue
        p = c["memory"]["argument_parts"]
        lines.append(
            f"| {arch} | {shape} | {p['params'] / 1e9:.2f} | "
            f"{p['state'] / 1e9:.2f} | {p['inputs'] / 1e9:.3f} | "
            f"{c['counts'].get('all-gather', 0.0) / 1e9:.2f} | "
            f"{c['memory']['peak_estimate_gb']:.1f} |")
    return "\n".join(lines)


def pick_hillclimb_cells(mesh: str = "single",
                         root: Optional[Path] = None) -> List:
    """worst roofline fraction / most collective-bound / most
    paper-representative (a decode cell of a GQA dense arch)."""
    cells = {k: v for k, v in load_cells(mesh, root=root).items()
             if v.get("ok") and not v.get("skipped")}
    worst = min(cells, key=lambda k: cells[k]["terms"]["roofline_fraction"])
    coll = max(cells, key=lambda k: (cells[k]["terms"]["collective_s"]
                                     / max(max(cells[k]["terms"]["compute_s"],
                                               cells[k]["terms"]["memory_s"]),
                                           1e-12)))
    paper = ("qwen2.5-3b", "decode_32k")
    return [worst, coll, paper]


if __name__ == "__main__":
    where = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    for mesh in ("single", "multi"):
        print(f"\n===== dryrun {mesh} =====")
        print(dryrun_table(mesh, where))
    print("\n===== roofline (single pod), modelled at H100 SXM peaks =====")
    print(roofline_table("single", root=where))
    print("\nhillclimb picks:", pick_hillclimb_cells(root=where))
    print("\n===== every cell, both meshes =====")
    print(summary_table(where))
    for mesh in ("single", "multi"):
        print(f"\n===== serving cells by part, {mesh} =====")
        print(serving_parts_table(mesh, where))
