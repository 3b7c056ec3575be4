"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro``, entry points
do not drop to the CPU unless asked, and the kernel wrappers never fall
back to their plain versions on a device tensor."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    """Every module of the package, and chip_smoke.py with what it
    imports, in a fresh interpreter: no jax and no repro module loads."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _entry_points():
    from repro_torch import convert
    from repro_torch.config.base import SpecConfig
    from repro_torch.configs import paper_target
    from repro_torch.core import drafter, pipeline, state
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api, lm
    tcfg = paper_target.smoke()
    dcfg = paper_target.drafter_small(gamma=4)
    bundle = pipeline.SpecBundle(tcfg, dcfg, dcfg,
                                 SpecConfig(gamma=4, top_k_branches=2),
                                 None, None, None)
    return {
        "lm_init": lambda: lm.lm_init(tcfg),
        "init_states": lambda: lm.init_states(tcfg, 1, 8),
        "drafter_init": lambda: drafter.drafter_init(dcfg),
        "engine_init": lambda: state.engine_init(bundle, 1, 8),
        "generate": lambda: pipeline.generate(bundle, [[1, 2]], 2),
        "generate_ondevice": lambda: pipeline.generate_ondevice(
            bundle, [[1, 2]], 2),
        "convert_lm": lambda: convert.convert_lm({}, tcfg),
        "convert_drafter": lambda: convert.convert_drafter({}),
        "init_model": lambda: api.init_model(tcfg),
        "make_train_step": lambda: steps.make_train_step(tcfg),
        "launch_train": lambda: launch_train.main(["--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["lm_init", "init_states", "drafter_init",
                                  "engine_init", "generate",
                                  "generate_ondevice", "convert_lm",
                                  "convert_drafter", "init_model",
                                  "make_train_step", "launch_train"])
def test_entry_point_without_device_raises_here(name):
    """Without ``device=`` an entry point asks for the card; on a machine
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_wrapper_never_falls_back_on_a_device_tensor(paged):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is taken only for CPU tensors."""
    from repro_torch.kernels import cascade_attention as casc
    q = torch.empty((1, 2, 4, 16), device="meta")
    kv = torch.empty((1, 2, 32, 16), device="meta")
    lens = torch.tensor([8], device="meta")
    qa = torch.empty((1, 4), dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        if paged:
            casc.cascade_phase1_paged(q, kv[0][None], kv[0][None],
                                      torch.zeros((1, 2), dtype=torch.int32),
                                      cache_len=lens, q_abs=qa)
        else:
            casc.cascade_phase1(q, kv, kv, cache_len=lens, q_abs=qa)


@pytest.mark.parametrize("which", ["fwd", "bwd_dq", "bwd_dkv"])
def test_flash_wrappers_never_fall_back_on_a_device_tensor(which):
    """The flash wrappers, like the cascade ones, take the plain version
    only for CPU tensors."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.empty((1, 4, 8, 16), device="meta")
    kv = torch.empty((1, 2, 8, 16), device="meta")
    rows = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        if which == "fwd":
            fa.flash_attention_fwd(q, kv, kv)
        elif which == "bwd_dq":
            fa.flash_attention_bwd_dq(q, kv, kv, q, rows, rows)
        else:
            fa.flash_attention_bwd_dkv(q, kv, kv, q, rows, rows)


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "FAIL" in out.stderr
