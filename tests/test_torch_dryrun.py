"""The port's multi-device dry run (ROADMAP.md item 10b:
``repro_torch/launch/steps.py``'s cell builders, ``launch/mesh.py``'s
production meshes, ``roofline/analysis.py``, ``roofline/report.py``,
``launch/dryrun.py``, ``kernels/trace.py``) held to the JAX package.

Nothing here traces a production cell: ``build_cell`` draws every cell's
arguments on the meta device (shapes only) and JAX's ``build_cell``
evaluates its shapes; the refusal and skip cells of the launcher stop
before any step runs. The shape-only trace is held to a real run in
``test_torch_mesh_train.py`` (the tiny (2, 2) FSDP cell on 4 gloo
ranks, and its FLOPs against JAX's HLO count).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.config.base import shape_by_name as jshape_by_name
from repro.config.registry import get_config as jget_config
from repro.distributed import compat as jcompat
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.roofline import analysis as jroof
from repro_torch.config.base import shape_by_name
from repro_torch.config.registry import ARCH_IDS, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import trace as ktrace
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import param as pm
from repro_torch.roofline import analysis as troof
from repro_torch.roofline import report

SHAPES = dryrun.ALL_SHAPES


def _jax_sizes(tree):
    """(total bytes, dtype names) of a tree of ShapeDtypeStructs."""
    leaves = jax.tree.leaves(tree)
    return (sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                for x in leaves),
            sorted({np.dtype(x.dtype).name for x in leaves}))


def _port_sizes(tree):
    leaves = list(pm.flatten(tree).values())
    return (sum(t.numel() * t.element_size() for t in leaves),
            sorted({str(t.dtype).replace("torch.", "") for t in leaves}))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_matches_jax(arch):
    """For each shape: JAX's ``build_cell`` and the port's give the same
    kind, logical rules and FSDP flag, and both skip the same
    ``long_500k`` cells (None). A train cell's params, optimizer state
    (``optimizer_for``'s choice, whole leaves) and batch have JAX's total
    bytes and dtypes; a serving cell's bundle (target and both
    production drafters in bf16) has JAX's bytes too. The port's
    arguments are meta tensors."""
    for shape in SHAPES:
        j = jsteps.build_cell(arch, shape)
        t = tsteps.build_cell(arch, shape)
        assert (j is None) == (t is None), shape
        if j is None:
            continue
        assert (t.kind, t.fsdp) == (j.kind, j.fsdp), shape
        assert t.rules == {k: v for k, v in j.rules.items()}, shape
        if t.kind == "train":
            for jt, tt in zip(j.args, t.args):
                assert _port_sizes(tt) == _jax_sizes(jt), shape
            assert all(v.device.type == "meta"
                       for v in pm.flatten(t.args[0]).values())
            continue
        jb = next(a for a in j.args if hasattr(a, "d1_params"))
        tb = next(a for a in t.args if hasattr(a, "d1_params"))
        for name in ("target_params", "d1_params", "d2_params"):
            assert _port_sizes(getattr(tb, name)) == _jax_sizes(
                getattr(jb, name)), (shape, name)


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_matches_jax(multi, monkeypatch):
    """``make_production_mesh`` without a process group: JAX's axis names
    and shape (read from the call JAX's ``make_production_mesh`` makes),
    and rank r at JAX's row-major device coordinates (``devices``
    reshaped to the mesh: device r at ``np.unravel_index(r, shape)``);
    every axis's group is shape-only, so a real tensor's collective
    raises and a meta tensor's only takes its shape."""
    seen = {}
    monkeypatch.setattr(jcompat, "make_mesh",
                        lambda shape, axes, **kw: seen.update(
                            shape=tuple(shape), axes=tuple(axes)))
    jmesh.make_production_mesh(multi_pod=multi)
    n = int(np.prod(seen["shape"]))
    layout = np.arange(n).reshape(seen["shape"])
    for r in (0, 1, 17, 255, n - 1):
        m = make_production_mesh(multi_pod=multi, rank=r)
        assert m.axis_names == seen["axes"]
        assert m.shape == seen["shape"]
        assert tuple(int(c) for c in np.argwhere(layout == r)[0]) == \
            m.coords
    with pytest.raises(ValueError):
        make_production_mesh(multi_pod=multi, rank=n)
    with pytest.raises(RuntimeError, match="meta tensors only"):
        m.all_reduce_(torch.zeros(3), torch.distributed.ReduceOp.SUM,
                      "model")
    tsh.reset_collectives()
    x = torch.empty((4, 8), device="meta")
    assert m.all_gather(x, "model").shape == (16, 4, 8)
    assert m.reduce_scatter(torch.empty((16, 8), device="meta"),
                            "data").shape == (8,)
    c = tsh.collective_counts()
    assert c["all-gather"] == {"calls": 1, "bytes": 15 * 4 * 8 * 4}
    assert c["reduce-scatter"] == {"calls": 1, "bytes": 15 / 16 * 16 * 8
                                   * 4}


def test_kernel_wrapper_on_meta_runs_plain_only_by_name():
    """A flash wrapper handed meta tensors raises; inside
    ``plain_on_meta`` it runs the plain version (the shapes of the CPU
    result) and counts the call under the kernel's name; the launch
    counters do not move."""
    q = torch.empty((1, 2, 8, 16), device="meta")
    k = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(RuntimeError, match="plain_on_meta"):
        fa.flash_attention_fwd(q, k, k)
    launches = fa.flash_attention_fwd.launches
    with ktrace.plain_on_meta() as traced:
        o, lse = fa.flash_attention_fwd(q, k, k)
        fa.flash_attention_fwd(q, k, k)
    assert traced == {"flash_fwd": 2}
    assert o.shape == q.shape and lse.shape == (1, 2, 8)
    assert o.device.type == "meta"
    assert fa.flash_attention_fwd.launches == launches


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_terms_match_jax(kind):
    """``model_flops`` and ``analytic_hbm_bytes`` equal JAX's for every
    registry id on the same inputs (exactly: the same float
    expressions); ``derive_terms`` gives JAX's terms scaled by the ratio
    of the peaks (compute 197e12 / 989e12, memory 819e9 / 3.35e12,
    collective 50e9 / the link's rate), relative 1e-12, and the same
    FLOPs, bytes and model FLOPs."""
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    counts = {"flops": 3.5e14, "coll_bytes": 2.5e10}
    for arch in ARCH_IDS:
        jc, tc = jget_config(arch), get_config(arch)
        js, ts = jshape_by_name(shape), shape_by_name(shape)
        tokens = ts.global_batch * ts.seq_len
        assert troof.model_flops(tc, tokens, kind == "train") == \
            jroof.model_flops(jc, tokens, kind == "train")
        args = (256, 3.1e9, 2.2e9, 4.4e9, 3.0 if kind == "decode" else 1.0)
        hbm = troof.analytic_hbm_bytes(tc, ts, kind, *args)
        assert hbm == jroof.analytic_hbm_bytes(jc, js, kind, *args)
        for link in (troof.NVLINK_BW, troof.INTER_HOST_BW):
            t = troof.derive_terms(tc, ts, kind, 256, counts, hbm, tokens,
                                   link=link).as_dict()
            j = jroof.derive_terms(jc, js, kind, 256, counts, hbm,
                                   tokens).as_dict()
            np.testing.assert_allclose(
                [t["compute_s"], t["memory_s"], t["collective_s"]],
                [j["compute_s"] * jroof.PEAK_FLOPS / troof.PEAK_FLOPS,
                 j["memory_s"] * jroof.HBM_BW / troof.HBM_BW,
                 j["collective_s"] * jroof.LINK_BW / link], rtol=1e-12)
            for key in ("flops_per_dev", "hbm_bytes_per_dev",
                        "coll_bytes_per_dev", "model_flops",
                        "hlo_flops_global", "chips", "useful_ratio"):
                assert t[key] == j[key], key


def test_link_rate_by_mesh_layout():
    """Eight cards a host: an axis whose ranks stay in a host gets
    NVLink, one that crosses hosts (both 16-wide axes of the production
    meshes) the inter-host rate."""
    assert troof.link_bw((2, 2)) == troof.NVLINK_BW
    assert troof.link_bw((2, 4)) == troof.NVLINK_BW
    assert troof.link_bw((1, 8)) == troof.NVLINK_BW
    assert troof.link_bw((4, 4)) == troof.INTER_HOST_BW
    assert troof.link_bw((16, 16)) == troof.INTER_HOST_BW
    assert troof.link_bw((2, 16, 16)) == troof.INTER_HOST_BW


def _record(arch, shape, mesh, dominant="memory", frac=0.25, **kw):
    terms = dict(compute_s=0.5, memory_s=1.5, collective_s=0.01,
                 dominant=dominant, useful_ratio=0.9,
                 roofline_fraction=frac)
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "kind": "decode",
           "ok": True, "trace_s": 1.5, "terms": terms,
           "memory": {"argument_bytes_per_dev": 3 * 2 ** 30,
                      "peak_estimate_gb": 4.25},
           "counts": {"flops": 2e12, "coll_bytes": 5 * 2 ** 20}}
    rec.update(kw)
    return rec


def test_report_renders_tables_from_jsons(tmp_path):
    """``report`` reads the dry run's JSONs from a directory: an ok cell
    with its terms and memory, a skipped one, a refusal with its ROADMAP
    item, a missing one, in each table (the summary puts both meshes
    side by side); the hill-climb picks the worst roofline fraction and
    the most collective-bound cell."""
    recs = [_record("qwen2.5-3b", "decode_32k", "single"),
            _record("stablelm-3b", "decode_32k", "single", frac=0.05,
                    terms=dict(compute_s=0.1, memory_s=0.2,
                               collective_s=0.9, dominant="collective",
                               useful_ratio=0.5, roofline_fraction=0.05)),
            {"arch": "qwen2.5-3b", "shape": "long_500k", "mesh": "single",
             "ok": True, "skipped": "long_500k requires sub-quadratic"},
            {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "single",
             "ok": False, "roadmap_item": "10d", "error": "x"}]
    for r in recs:
        name = dryrun._cell_name(r["arch"], r["shape"], r["mesh"])
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    table = report.roofline_table("single", root=tmp_path)
    assert "| qwen2.5-3b | decode_32k | 500.0ms | 1.50s | 10.0ms | " \
        "**memory** | 0.90 | 0.250 | 4.2 |" in table
    assert "| qwen2.5-3b | long_500k | skipped" in table
    assert "| gemma2-2b | train_4k | refused (10d) |" in table
    assert "| whisper-medium | train_4k | (missing) |" in table
    dr = report.dryrun_table("single", root=tmp_path)
    assert dr.startswith("mesh=single: 3/4 cells ok (1 skipped by design)")
    assert "| qwen2.5-3b | decode_32k | decode | 1.5 | 3.00 | 4.25 | " \
        "2000 | 5 |" in dr
    both = report.summary_table(root=tmp_path)
    assert "| qwen2.5-3b | decode_32k | ok | 3.00 | 4.2 | memory | 0.250 " \
        "| (missing) | | | | |" in both
    assert "| gemma2-2b | train_4k | refused (10d) | | | | | (missing) |" \
        in both
    assert report.pick_hillclimb_cells("single", root=tmp_path) == [
        ("stablelm-3b", "decode_32k"), ("stablelm-3b", "decode_32k"),
        ("qwen2.5-3b", "decode_32k")]


def test_dryrun_cli_records_refusal_and_skip(tmp_path, capsys):
    """The launcher on a cell that refuses before its step runs
    (gemma2-2b's 8 query heads on a model axis of 16) writes ``ok:
    false``, the error, the ROADMAP item it names (10d) and the
    traceback's tail, and exits 1; a ``long_500k`` cell of a quadratic
    target is skipped and ok."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma2-2b", "--shape", "train_4k",
                     "--mesh", "single", "--out-dir", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "gemma2-2b_train_4k_single.json")
                     .read_text())
    assert rec["ok"] is False and rec["roadmap_item"] == "10d"
    assert "NotImplementedError" in rec["error"]
    assert "Traceback" in rec["traceback"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                     "--mesh", "multi", "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "qwen2.5-3b_long_500k_multi.json")
                     .read_text())
    assert rec["ok"] is True and "skipped" in rec
    capsys.readouterr()
